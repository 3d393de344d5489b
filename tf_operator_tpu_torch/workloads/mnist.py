"""MNIST training workload — the pod-side program for BASELINE configs 1
and 5.

The counterpart of `tf_operator_tpu/workloads/mnist.py`: the same flags,
defaults, log lines (`mnist workload: role=... index=... nproc=...`,
`step {i} loss ...` every 10 steps, `resumed from checkpoint step N`,
`preempted at step N, checkpoint saved`, `final loss X`) and exit codes
(1 when --target-loss is missed, --preempt-exit-code at the preemption
step), plus the `step time ... ms over steps ..., ... images/s` line of the
port's workloads.  PS replicas park, as in the JAX workload: they have no
work on this path and wait for the controller to reap them.

Adam (`train/optim.adam`, optax.adam's) on `MnistMLP` or `MnistCNN` (its
dropout off, as the JAX workload calls it with train=False), the
parameters drawn from the replica index as the seed.  With
--checkpoint-dir the run resumes from the latest checkpoint; at
--preempt-at-step (first life only) it saves blocking and exits with
--preempt-exit-code (143, SIGTERM: retryable under RestartPolicy
ExitCode); --save-every saves in the background.

Usage: python -m tf_operator_tpu_torch.workloads.mnist --steps 100 [--batch 64]
Set TPUJOB_FORCE_PLATFORM=cpu to run on the CPU; otherwise a CUDA device
is required.
"""
from __future__ import annotations

import argparse
import functools
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--model", choices=("mlp", "cnn"), default="mlp")
    parser.add_argument("--target-loss", type=float, default=None)
    parser.add_argument("--checkpoint-dir", default=None,
                        help="save/resume train state here")
    parser.add_argument("--save-every", type=int, default=0,
                        help="checkpoint every N steps (0 = only on preempt)")
    parser.add_argument("--preempt-at-step", type=int, default=None,
                        help="simulate preemption: checkpoint, then exit "
                        "with --preempt-exit-code at this step (first life "
                        "only — a resumed process past this step runs on)")
    parser.add_argument("--preempt-exit-code", type=int, default=143,
                        help="143=SIGTERM, retryable per the exit-code "
                        "classifier")
    from .runner import (ProfileCapture, StepTimer, WorkloadContext,
                         add_profile_args, apply_forced_platform)

    add_profile_args(parser)
    args = parser.parse_args(argv)

    try:
        device = apply_forced_platform()
    except RuntimeError as e:
        print(f"mnist workload: {e}", flush=True)
        return 1

    ctx = WorkloadContext.from_env()
    print(f"mnist workload: role={ctx.replica_type} index={ctx.replica_index} "
          f"nproc={ctx.num_processes}", flush=True)

    if ctx.replica_type == "ps":
        # Parameter servers have no work on this path; wait for the
        # controller to reap us when workers complete (CleanPodPolicy).
        while True:
            time.sleep(1)

    from ..models.mnist import MnistCNN, MnistMLP
    from ..train.data import prefetch_to_device, synthetic_mnist
    from ..train.optim import adam
    from ..train.state import create_train_state
    from ..train.step import classification_loss_fn, make_train_step

    if args.model == "mlp":
        model = forward = MnistMLP()
    else:
        model = MnistCNN()
        forward = functools.partial(model, train=False)
    state = create_train_state(model, adam(args.lr), seed=ctx.replica_index,
                               device=device)
    step = make_train_step(classification_loss_fn(forward))
    ckpt = None
    start_step = 0
    if args.checkpoint_dir:
        from ..train.checkpoint import CheckpointManager

        ckpt = CheckpointManager(args.checkpoint_dir)
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(state)
            start_step = latest
            print(f"resumed from checkpoint step {start_step}", flush=True)

    data = prefetch_to_device(
        synthetic_mnist(args.batch, seed=ctx.replica_index), device)
    loss = float("inf")
    prof = ProfileCapture(args.profile_dir, start_step + args.profile_start,
                          args.profile_steps)
    timer = StepTimer(device, start_step)
    for i in range(start_step, args.steps):
        prof.step(i)
        state, metrics = step(state, next(data))
        loss = float(metrics["loss"])
        if i % 10 == 0:
            print(f"step {i} loss {loss:.4f}", flush=True)
        timer.step_done(i)
        done = i + 1
        if (ckpt is not None and args.preempt_at_step is not None
                and start_step < args.preempt_at_step == done):
            ckpt.save(state, step=done)
            # stop an active profiler trace and drain the manager before
            # exiting: a preemption with --profile-dir keeps its trace
            prof.close()
            ckpt.close()
            print(f"preempted at step {done}, checkpoint saved", flush=True)
            return args.preempt_exit_code
        if ckpt is not None and args.save_every and done % args.save_every == 0:
            # the periodic save writes in the background; the preemption
            # save above blocks because the process exits right after it
            ckpt.save(state, step=done, wait=False)
    line = timer.line(args.steps - 1, args.batch, "images")
    if line:
        print(line, flush=True)
    prof.close()
    if ckpt is not None:
        # drain in-flight background writes: a failed save fails the run
        ckpt.close()
    print(f"final loss {loss:.4f}", flush=True)
    if args.target_loss is not None and loss > args.target_loss:
        print(f"target loss {args.target_loss} not reached", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
