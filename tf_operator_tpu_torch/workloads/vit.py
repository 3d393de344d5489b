"""Vision Transformer training workload.

The counterpart of `tf_operator_tpu/workloads/vit.py`: the same flags,
defaults, exit 2 on an image size the patch size does not divide, and log
lines (`vit workload: role=... index=...`, `step {i} loss ...`, `final loss
... (... images/sec)`), plus the `step time ... ms over steps ..., ...
images/s` line.  AdamW with optax's defaults (`optim.adamw`).  The batch
stream is the reference's: `np.random.RandomState(replica_index)` Gaussian
images in f32 drawn on the host, B x H x W x 3 normals a step.  Attention
runs non-causal through the flash kernels at T = patches + 1.

Data parallel over the mesh's dp and fsdp axes (each rank keeps its rows
of the batch it draws), the parameters fully sharded over fsdp and, with
the ZeRO knob, the moments and the update over dp; the blocks tensor
parallel over tp; the tokens split over sp, whose ranks run the ring
(patches + CLS must divide by sp, else exit 2, as the JAX ring requires);
the ranks along pp and ep replicate the step, as the JAX workload's do.
The ranks that share rows (along tp, sp, pp, ep) take the first one's
batch.

Usage: python -m tf_operator_tpu_torch.workloads.vit --steps 100 --batch 256
"""
from __future__ import annotations

import argparse
import sys

def parser() -> argparse.ArgumentParser:
    from .runner import add_profile_args

    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--patch-size", type=int, default=16)
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--layers", type=int, default=12)
    parser.add_argument("--d-model", type=int, default=768)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--log-every", type=int, default=10)
    add_profile_args(parser)
    return parser


def main(argv=None) -> int:
    from .runner import (WorkloadContext, apply_forced_platform, plan_mesh,
                         pod_say, process_group, split_batch)

    args = parser().parse_args(argv)

    try:
        device = apply_forced_platform()
    except RuntimeError as e:
        pod_say(f"vit workload: {e}")
        return 1

    ctx = WorkloadContext.from_env()
    pod_say(f"vit workload: role={ctx.replica_type} "
            f"index={ctx.replica_index}")
    if args.image_size % args.patch_size:
        pod_say(f"--image-size {args.image_size} must divide by --patch-size "
                f"{args.patch_size}")
        return 2
    layout, rc = plan_mesh(ctx)
    if layout is None:
        return rc
    tokens = (args.image_size // args.patch_size) ** 2 + 1
    if tokens % layout.shape.get("sp", 1):
        pod_say(f"{tokens} tokens (patches + CLS) must divide by "
                f"sp={layout.shape['sp']}: ring attention needs T divisible "
                "by the sp axis size")
        return 2
    problem = split_batch(args.batch, layout)
    if problem:
        pod_say(problem)
        return 2
    with process_group(ctx, device, layout) as mesh:
        return _train(args, ctx, device, mesh, layout)


def build(args, mesh, seed: int = 0):
    """The model, AdamW and the reference's batch stream
    (`np.random.RandomState(seed)` Gaussian images, B x H x W x 3 f32 on
    the host, and labels) that `args` ask for, over `mesh` (None: one
    process); a `runner.WorkloadParts`."""
    import numpy as np

    from ..models.vit import ViT, vit_base_config
    from ..train.optim import adamw
    from ..train.step import classification_loss_fn
    from .runner import WorkloadParts

    patches = (args.image_size // args.patch_size) ** 2
    heads = max(1, args.d_model // 64)
    cfg = vit_base_config(
        num_layers=args.layers, num_heads=heads, d_model=args.d_model,
        d_ff=4 * args.d_model, max_len=patches + 1, mesh=mesh)
    model = ViT(cfg, num_classes=args.num_classes,
                patch_size=args.patch_size, image_size=args.image_size)
    rng = np.random.RandomState(seed)

    def batches():
        while True:
            yield {
                "x": rng.randn(args.batch, args.image_size, args.image_size,
                               3).astype(np.float32),
                "label": rng.randint(0, args.num_classes,
                                     args.batch).astype(np.int32),
            }

    return WorkloadParts(model=model, tx=adamw(args.lr),
                  loss=classification_loss_fn(model), batches=batches(),
                  moments_per_param=2)


def _train(args, ctx, device, mesh, layout) -> int:
    from ..train.data import prefetch_to_device
    from ..train.step import make_train_step, shard_rows
    from .runner import (ProfileCapture, run_steps, same_batch_over_replicas,
                         say, train_state_on_mesh)

    parts = build(args, mesh, seed=ctx.replica_index)
    state = train_state_on_mesh(parts.model, parts.tx, device, mesh,
                                layout, ctx.zero_shard_weight_update)
    if state is None:
        return 2
    step = make_train_step(parts.loss, mesh=mesh)
    batches = parts.batches if mesh is None else (
        shard_rows(b, state.sharding) for b in parts.batches)
    loss, elapsed = run_steps(
        state, step, same_batch_over_replicas(
            prefetch_to_device(batches, device), state.sharding),
        steps=args.steps, device=device, log_every=args.log_every,
        profile=ProfileCapture(args.profile_dir, args.profile_start,
                               args.profile_steps),
        items=args.batch, unit="images")
    say(f"final loss {loss:.4f} ({args.steps * args.batch / elapsed:.1f} "
        "images/sec)")
    return 0


if __name__ == "__main__":
    from tf_operator_tpu_torch.workloads.launch import run_pod

    sys.exit(run_pod(main))
