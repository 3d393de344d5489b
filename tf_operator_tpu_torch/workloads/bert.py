"""BERT fine-tune workload (BASELINE config 4): sequence classification.

The counterpart of `tf_operator_tpu/workloads/bert.py`: the same flags,
defaults and log lines (`bert workload: role=... index=...`, `step {i}
loss ...` every 10 steps, `done`), plus `--log-every` (default 10) and the
`step time ... ms over steps ..., ... sequences/s` line.  BERT-base
(heads = d/64, d_ff 4d) with two labels, AdamW with optax's defaults
(`optim.adamw`), on the reference's `np.random.RandomState(replica_index)`
token and label stream.  Attention runs non-causal through the flash
kernels at T = --seq-len.

Data parallel over the mesh's dp and fsdp axes, the parameters fully
sharded over fsdp and, with the ZeRO knob, the moments and the update over
dp; the blocks tensor parallel and the token embedding vocab-sharded over
tp; the sequence split over sp, whose ranks run the ring (--seq-len must
divide by sp, else exit 2, as the JAX ring requires); the ranks along pp
and ep replicate the step, as the JAX workload's do.  The ranks that share
rows (along tp, sp, pp, ep) take the first one's batch.

Usage: python -m tf_operator_tpu_torch.workloads.bert --steps 50
"""
from __future__ import annotations

import argparse
import sys

def parser() -> argparse.ArgumentParser:
    from .runner import add_profile_args

    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--lr", type=float, default=5e-5)
    parser.add_argument("--layers", type=int, default=12)
    parser.add_argument("--d-model", type=int, default=768)
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
        pod_say(f"bert workload: {e}")
        return 1

    ctx = WorkloadContext.from_env()
    pod_say(f"bert workload: role={ctx.replica_type} "
            f"index={ctx.replica_index}")
    layout, rc = plan_mesh(ctx)
    if layout is None:
        return rc
    if args.seq_len % layout.shape.get("sp", 1):
        pod_say(f"--seq-len {args.seq_len} must divide by "
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
    """BERT-base at `args`' widths with two labels, AdamW and the
    reference's token and label stream (`np.random.RandomState(seed)`),
    over `mesh` (None: one process); a `runner.WorkloadParts`."""
    import numpy as np

    from ..models.transformer import BertEncoder, bert_base_config
    from ..train.optim import adamw
    from ..train.step import classification_loss_fn
    from .runner import WorkloadParts

    cfg = bert_base_config(
        num_layers=args.layers, d_model=args.d_model,
        num_heads=max(1, args.d_model // 64), d_ff=args.d_model * 4,
        max_len=args.seq_len, mesh=mesh)
    model = BertEncoder(cfg, num_labels=2)
    rng = np.random.RandomState(seed)

    def batches():
        while True:
            yield {
                "x": rng.randint(
                    0, cfg.vocab_size, (args.batch, args.seq_len)
                ).astype(np.int32),
                "label": rng.randint(0, 2, args.batch).astype(np.int32),
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
    run_steps(state, step,
              same_batch_over_replicas(prefetch_to_device(batches, device),
                                       state.sharding),
              steps=args.steps, device=device, log_every=args.log_every,
              profile=ProfileCapture(args.profile_dir, args.profile_start,
                                     args.profile_steps),
              items=args.batch, unit="sequences")
    say("done")
    return 0


if __name__ == "__main__":
    from tf_operator_tpu_torch.workloads.launch import run_pod

    sys.exit(run_pod(main))
