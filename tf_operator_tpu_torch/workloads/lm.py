"""LM pretraining workload: one CUDA device per process (or the CPU, on
request); over several processes, data parallel over the mesh's `dp` axis,
fully sharded (FSDP2) over `fsdp`, tensor parallel over `tp`, sequence
parallel (ring or Ulysses) over `sp` and, with `--moe-experts`, expert
parallel over `ep`, with ZeRO weight-update sharding over dp on request
(`--zero-shard-weight-update` or the spec knob's env).  The ranks along
`pp` (and `ep` without experts) replicate the step, as the JAX workload's
do: it builds no pipeline (the pipeline-parallel LM is
`models/pipeline_lm.py`).  After training,
`--sample-tokens N` decodes N tokens greedily with the KV cache
(`--kv-cache-dtype`) from an 8-token prompt and prints `sample: [...]`.

The counterpart of `tf_operator_tpu/workloads/lm.py`: the same flags,
defaults, exit-2 rejections and log lines (`step {i} loss ...`,
`resumed from step ...`, `sample: [...]`, `done`), plus, with experts,
`step {i} moe_aux_loss ...` beside each loss line, and one `step time ...`
line: the mean wall time of the run's steps after its first, periodic
checkpoint saves included, and the global batch's tokens/s.  In a process
group only rank 0 prints them.  Checkpoints make a preempted pod resume from its latest
step.  Under ZeRO the `zero_sharding_plan: {...}` line is the JAX
workload's.

Usage: python -m tf_operator_tpu_torch.workloads.lm --steps 100 \
           --checkpoint-dir /tmp/ckpt
Set TPUJOB_FORCE_PLATFORM=cpu to run on the CPU (the attention kernels'
plain versions); otherwise a CUDA device is required.
"""
from __future__ import annotations

import argparse
import sys

def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=2048)
    parser.add_argument("--vocab", type=int, default=32000)
    parser.add_argument("--layers", type=int, default=12)
    parser.add_argument("--d-model", type=int, default=768)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--lr-schedule", choices=("constant", "cosine"),
                        default="constant")
    parser.add_argument("--warmup-steps", type=int, default=0)
    parser.add_argument("--weight-decay", type=float, default=0.1)
    parser.add_argument("--grad-clip", type=float, default=1.0)
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--checkpoint-every", type=int, default=20)
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--seq-parallel", choices=("ring", "ulysses"),
                        default="ring",
                        help="strategy on the sp mesh axis")
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="microbatches per optimizer step (activation "
                             "memory / N, same update math)")
    parser.add_argument("--zero-shard-weight-update", action="store_true",
                        dest="zero_shard_weight_update", default=None,
                        help="shard optimizer state + weight update over "
                             "the dp mesh axis. Defaults to the spec knob "
                             "injected as TPUJOB_ZERO_SHARD_WEIGHT_UPDATE")
    parser.add_argument("--no-zero-shard-weight-update", action="store_false",
                        dest="zero_shard_weight_update", default=None,
                        help="force the dense weight update even when the "
                             "spec knob injected the env")
    parser.add_argument("--moe-experts", type=int, default=0,
                        help="enable MoE with this many experts")
    parser.add_argument("--moe-aux-weight", type=float, default=0.01)
    from .runner import add_profile_args

    add_profile_args(parser)
    parser.add_argument("--arch", choices=("gpt", "llama"), default="gpt",
                        help="gpt: learned positions + LayerNorm + GELU; "
                             "llama: RoPE + RMSNorm + SwiGLU + GQA")
    parser.add_argument("--kv-heads", type=int, default=0,
                        help="GQA KV heads for --arch llama (0 = heads/3)")
    parser.add_argument("--rope-scaling", choices=("none", "linear", "ntk"),
                        default="none",
                        help="context extension for RoPE models (requires "
                             "--arch llama)")
    parser.add_argument("--rope-factor", type=float, default=1.0,
                        help="extension factor for --rope-scaling")
    parser.add_argument("--attn-window", type=int, default=0,
                        help="sliding-window attention: each token attends "
                             "its last N positions (0 = full; the kernels "
                             "skip key tiles outside the band)")
    parser.add_argument("--attn-sink", type=int, default=0,
                        help="attention sinks: with --attn-window, keep the "
                             "first N positions visible to every token")
    parser.add_argument("--kv-cache-dtype", choices=("model", "int8"),
                        default="model",
                        help="decode KV-cache storage for --sample-tokens")
    parser.add_argument("--loss-chunk", type=int, default=0,
                        help="compute the cross-entropy in T-chunks of "
                             "this size so the full [B,T,vocab] logits "
                             "never materialize (0 = one-shot)")
    parser.add_argument("--sample-tokens", type=int, default=0,
                        help="after training, greedily generate this many "
                             "tokens with the KV-cache decode path")
    args = parser.parse_args(argv)

    from .runner import (WorkloadContext, apply_forced_platform, plan_mesh,
                         pod_say)

    try:
        device = apply_forced_platform()
    except RuntimeError as e:
        pod_say(f"lm workload: {e}")
        return 1

    if args.grad_accum < 1 or args.batch % args.grad_accum:
        pod_say(f"--grad-accum {args.grad_accum} must be >= 1 and divide "
                f"--batch {args.batch}")
        return 2
    SAMPLE_PROMPT_LEN = 8
    if args.sample_tokens > 0 and (
        SAMPLE_PROMPT_LEN + args.sample_tokens > args.seq_len
    ):
        # honored or rejected, never silently clamped
        pod_say(f"--sample-tokens {args.sample_tokens} needs prompt "
                f"({SAMPLE_PROMPT_LEN}) + tokens <= --seq-len {args.seq_len}")
        return 2

    ctx = WorkloadContext.from_env()
    pod_say(f"lm workload: role={ctx.replica_type} index={ctx.replica_index} "
            f"mesh={ctx.mesh_shape}")
    if ctx.is_elastic:
        pod_say(f"elastic mapping: virtual={ctx.virtual_replicas} "
                f"physical={ctx.physical_replicas} "
                f"generation={ctx.elastic_generation} "
                f"hosted={ctx.virtual_assignment()}")

    zero = (ctx.zero_shard_weight_update if args.zero_shard_weight_update
            is None else args.zero_shard_weight_update)
    layout, rc = plan_mesh(ctx)
    if layout is None:
        return rc
    from .runner import split_batch

    sp, tp = layout.shape.get("sp", 1), layout.shape.get("tp", 1)
    problem = split_batch(args.batch, layout, args.grad_accum)
    if problem:
        pod_say(problem)
        return 2
    if args.seq_len % sp:
        pod_say(f"--seq-len {args.seq_len} must divide by sp={sp}")
        return 2

    from ..models.transformer import TransformerConfig
    from ..train.optim import lm_optimizer

    heads = max(1, args.d_model // 64)
    extra = {}
    d_ff = args.d_model * 4
    if args.arch != "llama" and args.rope_scaling != "none":
        # explicit input is honored or rejected, never silently dropped:
        # only the llama arch uses RoPE, so scaling has nothing to scale
        pod_say(f"--rope-scaling {args.rope_scaling} requires --arch llama "
                "(the gpt arch uses learned positions, not RoPE)")
        return 2
    if args.arch == "llama":
        if args.kv_heads:
            kv = args.kv_heads
            # honored or rejected, never silently changed; the kv % tp
            # constraint binds only when the heads shard at all (heads %
            # tp == 0): otherwise the projections replicate
            problem = None
            if kv <= 0:
                problem = "must be positive"
            elif heads % kv:
                problem = f"must divide num_heads {heads}"
            elif heads % tp == 0 and kv % tp:
                problem = f"must be divisible by tp={tp}"
            if problem:
                pod_say(f"--kv-heads {kv} {problem}")
                return 2
            if heads % tp:
                pod_say(f"warning: num_heads {heads} not divisible by "
                        f"tp={tp}; attention projections will replicate")
        elif heads % tp:
            # the heads do not shard over tp (the projections replicate),
            # so kv % tp is moot: a divisor of heads near heads // 3
            kv = max(1, heads // 3)
            while heads % kv:
                kv -= 1
            pod_say(f"warning: num_heads {heads} not divisible by tp={tp}; "
                    f"attention projections will replicate")
        else:
            # derived default: largest kv <= heads // 3 that divides heads
            # and shards over the tp axis
            kv = max(1, heads // 3)
            while kv > 1 and (heads % kv or kv % tp):
                kv -= 1
            if heads % kv or kv % tp:
                # tp divides heads here, so kv = tp satisfies both
                kv = tp
        extra = dict(num_kv_heads=kv, use_rope=True, norm="rmsnorm",
                     mlp="swiglu", rope_scaling=args.rope_scaling,
                     rope_factor=args.rope_factor)
        # SwiGLU has 3 matrices; 8/3 scaling keeps MLP params comparable
        # to the 2-matrix GELU MLP at 4*d_model
        d_ff = args.d_model * 8 // 3
    try:
        # validated against the mesh's layout; the model gets the mesh over
        # the process group once this process has joined it
        cfg = TransformerConfig(
            vocab_size=args.vocab, num_layers=args.layers,
            num_heads=heads, d_model=args.d_model,
            d_ff=d_ff, max_len=args.seq_len, mesh=layout,
            seq_parallel=args.seq_parallel,
            remat=args.remat, moe_num_experts=args.moe_experts,
            attn_window=args.attn_window, attn_sink=args.attn_sink,
            kv_cache_dtype=args.kv_cache_dtype, **extra,
        )
    except ValueError as e:
        pod_say(f"invalid model config: {e}")
        return 2
    try:
        tx = lm_optimizer(
            args.lr, schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
            total_steps=args.steps, weight_decay=args.weight_decay,
            grad_clip=args.grad_clip,
        )
    except ValueError as e:
        pod_say(f"invalid optimizer config: {e}")
        return 2
    from .runner import process_group

    with process_group(ctx, device, layout) as mesh:
        return _train(args, cfg, tx, device, mesh, layout, zero,
                      ctx.world, SAMPLE_PROMPT_LEN)


def _train(args, cfg, tx, device, mesh, layout, zero, ranks: int,
           prompt_len: int) -> int:
    """Build and train the model: over `mesh` (laid over the process
    group) when there is one (laid out on its axes; the distributed step,
    this rank's shard of each global batch), else on one device; then
    sample from it.  Only rank 0 prints, but each pod prints the ZeRO plan
    line, as every process of the JAX workload does."""
    import dataclasses

    from ..models.transformer import TransformerLM
    from ..train.data import prefetch_to_device, synthetic_tokens
    from ..train.step import lm_loss_fn, make_train_step, shard_batch
    from .runner import (ProfileCapture, StepTimer, say,
                         train_state_on_mesh)

    if mesh is not None:
        cfg = dataclasses.replace(cfg, mesh=mesh)
    state = train_state_on_mesh(TransformerLM(cfg), tx, device, mesh, layout,
                                zero)
    if state is None:
        return 2
    mgr = None
    if args.checkpoint_dir:
        from ..train.checkpoint import CheckpointManager

        mgr = CheckpointManager(args.checkpoint_dir)
        state = mgr.restore(state)
        if mgr.latest_step() is not None:
            say(f"resumed from step {state.step}")

    step = make_train_step(
        lm_loss_fn(state.model,
                   moe_aux_weight=(args.moe_aux_weight if args.moe_experts
                                   else 0.0),
                   loss_chunk=args.loss_chunk),
        grad_accum=args.grad_accum, mesh=mesh)
    # every rank draws the same global stream and keeps its shard
    batches = synthetic_tokens(args.batch, args.seq_len + 1, args.vocab)
    if mesh is not None:
        batches = (shard_batch(b, state.sharding, args.grad_accum) for b in batches)
    data = prefetch_to_device(batches, device)

    start = state.step
    prof = ProfileCapture(args.profile_dir, start + args.profile_start,
                          args.profile_steps)
    timer = StepTimer(device, start)
    for i in range(start, args.steps):
        prof.step(i)
        state, metrics = step(state, next(data))
        if i % 10 == 0:
            say(f"step {i} loss {float(metrics['loss']):.4f}")
            if "moe_aux_loss" in metrics:
                say(f"step {i} moe_aux_loss "
                    f"{float(metrics['moe_aux_loss']):.4f}")
        if mgr is not None and (i + 1) % args.checkpoint_every == 0:
            # written in the background; the final save below waits
            mgr.save(state, wait=False)
        timer.step_done(i)
    # the global batch's tokens
    line = timer.line(args.steps - 1, args.batch * args.seq_len, "tokens")
    if line:
        say(line)
    prof.close()
    if mgr is not None:
        mgr.save(state)
        mgr.close()
    timer.sync()
    if args.sample_tokens > 0 and ranks > 1:
        # every rank would sample the same tokens
        say("sampling skipped on multi-host runs")
    elif args.sample_tokens > 0:
        from ..models.generate import generate

        prompt = next(synthetic_tokens(1, prompt_len + 1, args.vocab))[
            "tokens"][:, :prompt_len]
        out = generate(state.model, prompt, args.sample_tokens)
        say(f"sample: {out[0].tolist()}")
    say("done")
    return 0


if __name__ == "__main__":
    from tf_operator_tpu_torch.workloads.launch import run_pod

    sys.exit(run_pod(main))
