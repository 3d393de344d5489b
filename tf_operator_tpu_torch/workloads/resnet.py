"""ResNet-50 training workload (BASELINE config 3).

The counterpart of `tf_operator_tpu/workloads/resnet.py`: the same flags,
defaults and log lines (`resnet workload: role=... index=...`, `step {i}
loss ...`, `done: N steps, X img/s`), plus the `step time ... ms over
steps ..., ... images/s` line of the port's workloads.  SGD with momentum
0.9 on the native image loader (the Python generator where it does not
build; one line names the source).  Images are copied to the device in f32
and cast to bf16 there (round to nearest even, the values the reference's
host-side cast gives).

Sync data parallelism: with several processes the batch is split over the
mesh's data axes, dp and fsdp (every rank draws the global stream and keeps
its rows; the native loader's threads hand batches over in no fixed order,
so, as in the reference, the ranks' rows need not come from one global
batch), the gradients are summed over the ranks, and BatchNorm's batch
statistics are those of the global batch (its sums all-reduced over the
data ranks), as the JAX step's one jit over the globally sharded batch
computes them.  fsdp shards the parameters (FSDP2), and ZeRO
weight-update sharding (the spec knob's env) the momentum and the update
over dp, printing the JAX workload's plan line.  The ranks along pp, ep,
tp and sp replicate the step, as the JAX workload's do (its data axes are
dp and fsdp, and no sharding rule matches a conv): each batch is broadcast
over them, so they read one batch from the native loader.

Usage: python -m tf_operator_tpu_torch.workloads.resnet --steps 100 --batch 256
Set TPUJOB_FORCE_PLATFORM=cpu to run on the CPU; otherwise a CUDA device
is required.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--depth", type=int, default=50,
                        choices=(18, 34, 50, 101, 152))
    parser.add_argument("--log-every", type=int, default=10)
    from .runner import (WorkloadContext, add_profile_args,
                         apply_forced_platform, plan_mesh, pod_say,
                         process_group, split_batch)

    add_profile_args(parser)
    args = parser.parse_args(argv)

    try:
        device = apply_forced_platform()
    except RuntimeError as e:
        pod_say(f"resnet workload: {e}")
        return 1

    ctx = WorkloadContext.from_env()
    pod_say(f"resnet workload: role={ctx.replica_type} "
            f"index={ctx.replica_index}")
    layout, rc = plan_mesh(ctx)
    if layout is None:
        return rc
    problem = split_batch(args.batch, layout)
    if problem:
        pod_say(problem)
        return 2
    with process_group(ctx, device, layout) as mesh:
        return _train(args, device, mesh, layout,
                      ctx.zero_shard_weight_update)


def _train(args, device, mesh, layout, zero) -> int:
    import numpy as np
    import torch

    from ..models import resnet as resnet_lib
    from ..train.data import prefetch_to_device
    from ..train.native_data import images_or_fallback
    from ..train.optim import sgd
    from ..train.step import (classification_loss_fn, make_train_step,
                              shard_rows)
    from .runner import (ProfileCapture, run_steps, same_batch_over_replicas,
                         say, train_state_on_mesh)

    from ..parallel.mesh import data_axes

    # BatchNorm's sums over every data rank (dp and fsdp)
    group = None
    if mesh is not None and int(np.prod(
            [mesh.shape[a] for a in data_axes(mesh)], initial=1)) > 1:
        group = mesh.group_over(data_axes(mesh))
        if group is None:
            group = torch.distributed.group.WORLD
    model = getattr(resnet_lib, f"ResNet{args.depth}")(
        num_classes=args.num_classes, dtype=torch.bfloat16, bn_group=group)
    state = train_state_on_mesh(model, sgd(args.lr), device, mesh, layout,
                                zero)
    if state is None:
        return 2
    step = make_train_step(classification_loss_fn(model), mesh=mesh)

    raw = images_or_fallback(args.batch, args.image_size, args.num_classes)
    batches = raw if mesh is None else (shard_rows(b, state.sharding)
                                        for b in raw)
    data = ({**b, "x": b["x"].to(torch.bfloat16)}
            for b in same_batch_over_replicas(
                prefetch_to_device(batches, device), state.sharding))
    try:
        _, elapsed = run_steps(
            state, step, data, steps=args.steps, device=device,
            log_every=args.log_every,
            profile=ProfileCapture(args.profile_dir, args.profile_start,
                                   args.profile_steps),
            items=args.batch, unit="images")
    finally:
        if hasattr(raw, "close"):
            raw.close()
    say(f"done: {args.steps} steps, {args.steps * args.batch / elapsed:.1f} "
        "img/s")
    return 0


if __name__ == "__main__":
    from tf_operator_tpu_torch.workloads.launch import run_pod

    sys.exit(run_pod(main))
