"""Distributed MNIST with a real async parameter server (BASELINE config 2).

The counterpart of `tf_operator_tpu/workloads/dist_mnist.py` (the
reference's dist-mnist example, examples/v1/dist-mnist/dist_mnist.py:98-143):
PS replicas serve parameter shards from host memory (`train/ps.py`; the PS
is a host pattern by design and computes nothing on the card); workers read
TF_CONFIG for the PS addresses and, every step, pull the parameters onto
their device, compute the mean NLL gradient there, copy it to the host and
push it asynchronously.  Worker 0's clean exit marks the job Succeeded (the
worker-0 rule); PS replicas serve until CleanPodPolicy reaps them.

Every process draws the same initial `MnistMLP` (seed 0) and the wire
carries its flax names and layouts (`models/convert.mnist_to_flax`), so a
port worker can use a JAX PS shard and the other way round.  Two
transports: the Python socket PS (`train/ps.py`) and the native C++ shard
server (`train/native_ps.py`), picked with --transport or
TPUJOB_PS_TRANSPORT; `--transport native` without a buildable library
exits 2 (no process falls back on its own).  Besides the JAX workload's
lines a worker prints the `step time ... ms over steps ..., ... images/s`
line and its mean pull and push times per step.

Usage: python -m tf_operator_tpu_torch.workloads.dist_mnist --steps 100
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from ..api import constants


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--target-loss", type=float, default=None)
    parser.add_argument(
        "--transport",
        choices=("python", "native"),
        default=os.environ.get(constants.ENV_PS_TRANSPORT, "python"),
        help="PS wire transport: python (pickle sockets) or native (C++ "
             "shard server, binary protocol)",
    )
    args = parser.parse_args(argv)

    from .runner import WorkloadContext, apply_forced_platform

    try:
        device = apply_forced_platform()
    except RuntimeError as e:
        print(f"dist-mnist: {e}", flush=True)
        return 1

    ctx = WorkloadContext.from_env()
    print(f"dist-mnist: role={ctx.replica_type} index={ctx.replica_index}",
          flush=True)

    if ctx.tf_config is None:
        print("dist_mnist requires a distributed TF_CONFIG topology", flush=True)
        return 2
    cluster = ctx.tf_config.get("cluster") or ctx.tf_config.get("sparseCluster") or {}
    ps_addresses = list(cluster.get("ps", []))
    if not ps_addresses:
        print("no PS replicas in cluster spec", flush=True)
        return 2

    import torch

    from ..models.convert import mnist_to_flax
    from ..models.mnist import MnistMLP
    from ..train import ps as ps_lib

    model = MnistMLP()
    model.reset_parameters(torch.Generator().manual_seed(0))
    flat_init = ps_lib.flatten_params(mnist_to_flax(model.state_dict()))

    native = args.transport == "native"
    if native:
        from ..train import native_ps

        if not native_ps.native_ps_available():
            # Hard failure, not a fallback: every replica chooses its
            # transport independently, and a PS that silently fell back to
            # pickle while the workers speak the binary protocol (or vice
            # versa) just drops every connection with no diagnosis.
            print("native PS transport unavailable (g++ build failed) and "
                  "--transport native was requested; refusing to fall back "
                  "per-process", flush=True)
            return 2

    if ctx.replica_type == "ps":
        # Serve this shard until a worker sends shutdown (or we are reaped).
        return ps_lib.serve_shard(
            flat_init, ps_addresses, ctx.replica_index, args.lr,
            native=native)

    # --- worker ---
    try:
        client, _ = ps_lib.connect_with_retry(ps_addresses, native=native)
    except ConnectionError as e:
        print(str(e), flush=True)
        return 1
    return _train(args, ctx.replica_index, device, model, flat_init, client,
                  "native" if native else "python")


def load_flat(model, flat, template) -> None:
    """Copy the flax-named parameters `flat` (the wire's or a checkpoint's
    f32 arrays, any shape of the right size: the native wire carries them
    1-D) onto the MNIST `model`, on its device, each reshaped to its
    array in `template` (the flax-named initial parameters)."""
    import numpy as np
    import torch

    from ..models.convert import mnist_from_flax
    from ..train import ps as ps_lib

    params = dict(model.named_parameters())
    tree = ps_lib.unflatten_params(
        {n: np.asarray(a).reshape(template[n].shape) for n, a in flat.items()})
    with torch.no_grad():
        for name, value in mnist_from_flax(tree).items():
            params[name].copy_(value)


def grad_fn(model, flat, template, x, y):
    """(loss, flat gradients) of the mean NLL of `model` at the parameters
    `flat` (as `load_flat` takes them) on the device batch (x, y); the
    gradients come back to the host as f32 arrays under the flax names and
    layouts."""
    from ..models.convert import mnist_to_flax
    from ..train import ps as ps_lib
    from ..train.step import softmax_cross_entropy

    load_flat(model, flat, template)
    model.zero_grad(set_to_none=True)
    loss = softmax_cross_entropy(model(x), y)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return loss.detach(), ps_lib.flatten_params(mnist_to_flax(grads))


def _train(args, index: int, device, model, flat_init, client,
           transport: str) -> int:
    from ..train.data import prefetch_to_device, synthetic_mnist
    from .runner import StepTimer

    model.to(device)
    data = prefetch_to_device(synthetic_mnist(args.batch, seed=100 + index),
                              device)
    timer = StepTimer(device, 0)
    pull_s = push_s = 0.0
    loss = float("inf")
    for step_idx in range(args.steps):
        batch = next(data)
        t0 = time.perf_counter()
        flat = client.pull()
        t1 = time.perf_counter()
        loss_val, grads = grad_fn(model, flat, flat_init, batch["x"],
                                  batch["label"])
        t2 = time.perf_counter()
        client.push(grads)
        t3 = time.perf_counter()
        if step_idx > 0:
            pull_s += t1 - t0
            push_s += t3 - t2
        loss = float(loss_val)
        if step_idx % 10 == 0:
            print(f"worker {index} step {step_idx} loss {loss:.4f}",
                  flush=True)
        timer.step_done(step_idx)
    line = timer.line(args.steps - 1, args.batch, "images")
    if line:
        timed = args.steps - 1
        print(line, flush=True)
        print(f"worker {index} pull {pull_s / timed * 1e3:.3f} ms + push "
              f"{push_s / timed * 1e3:.3f} ms per step over steps "
              f"1-{timed}", flush=True)
    print(f"worker {index} ({transport} transport) final loss {loss:.4f}",
          flush=True)
    client.close()
    if args.target_loss is not None and loss > args.target_loss:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
