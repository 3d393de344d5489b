"""Flash attention for the H100: three hand-written CUDA kernels and their
plain PyTorch versions.

The counterpart of `tf_operator_tpu/ops/attention.py`.  Layout: q/k/v are
[batch, heads, seq, head_dim]; k/v may carry fewer (grouped-query) heads
than q (heads % kv_heads == 0) and are never repeated in memory by the
kernels.  Masks: causal, sliding window (`window`, requires causal) and
attention sinks (`sink`, requires a window), with the same validation as
the JAX package.

Dispatch is decided by the tensors' device, outside autograd:
  * a CPU tensor runs the plain version (`attention_lse`) under ordinary
    autograd;
  * a CUDA tensor goes through `FlashAttentionFn`, whose forward launches
    the forward kernel (saving the per-row logsumexp) and whose backward
    launches the dq and the dk/dv kernels; `flash_attention_lse` returns
    the lse too, through `FlashAttentionLseFn`, whose backward takes a
    cotangent on it as well.  The kernels take what the Pallas kernels
    take: bf16 and fp16 (tensor cores) and f32 (the forward on SIMT
    kernels of its own, dq and dk/dv on the tensor cores in three TF32
    passes),
    any head_dim (one that is not a multiple of 8 is zero-padded here and
    the outputs sliced; above 256 the sliced kernels, `SLICED`, take it),
    any scale, any batch*heads, and any block sizes, which `resolve_tiles`
    maps onto the instantiated tiles; at head dims up to 64 in bf16 and
    fp16 a sequence of at most 256 takes the encoders' forward, dq and
    dk/dv kernels whatever the blocks (`short_route`).  A CUDA tensor the
    kernels do not take (another dtype, non-contiguous, a grid past 2^31 - 1
    blocks) raises; nothing falls back.

Each kernel wrapper (`flash_forward`, `flash_backward_dq`,
`flash_backward_dkv`, and `dkv_reduce`, which sums the slices dk/dv is
split into at head-dim class 256) computes its kernel's plain version when
handed CPU tensors, and counts, in its `launches` attribute, every time it
launches its kernel (and `short_launches`, the launches of the encoders'
kernels among them, `sliced_launches`, those of the kernels above head
dim 256, and of those `cluster_launches`, the launches of dq's and
dk/dv's clusters (the cluster kernels' in bf16 and fp16, the tensor-core
kernels' in f32), and `pair_launches`, the pair forward's; f32 dq and
dk/dv launch only their kernels on the tensor cores, so their `launches`
are those kernels').
The kernels live in `csrc/flash_attention.cu` (with the Hopper building
blocks in `csrc/hopper.cuh`) and are built at first use (`_build.py`).
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Optional, Tuple

import torch

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# validation, shared with the plain path


def check_sink(window: Optional[int], sink: int) -> int:
    """Normalize the attention-sink knob: 0 = none; positive requires a
    sliding window (sinks only change behavior when distant context is
    otherwise masked off)."""
    if not sink:
        return 0
    if sink < 0:
        raise ValueError(f"sink must be >= 0, got {sink}")
    if window is None:
        raise ValueError(
            "attention sinks require a sliding window (without one every "
            "position already attends the first tokens)")
    return int(sink)


def check_window(causal: bool, window: Optional[int]) -> Optional[int]:
    """Normalize the sliding-window knob: None/0 -> full attention; a
    positive window requires causal."""
    if not window:
        return None
    if window < 0:
        raise ValueError(f"window must be positive, got {window}")
    if not causal:
        raise ValueError("sliding-window attention requires causal=True")
    return int(window)


def repeat_kv(q, k, v):
    """Widen GQA k/v to q's head count (what the plain version needs; the
    kernels map each query head to its KV head instead)."""
    group = q.shape[1] // k.shape[1]
    if group == 1:
        return k, v
    return (k.repeat_interleave(group, dim=1),
            v.repeat_interleave(group, dim=1))


def check_gqa(q, k):
    if q.shape[1] % k.shape[1]:
        raise ValueError(
            f"q heads {q.shape[1]} must be a multiple of kv heads {k.shape[1]}"
        )


def _env_block(name: str, multiple: int) -> int:
    raw = os.environ.get(name, "128")
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not an integer (this env var carries a tuned "
            "block size to workloads)") from None
    if value <= 0 or value % multiple:
        raise ValueError(
            f"{name}={value} must be a positive multiple of {multiple}")
    return value


def default_blocks(block_q, block_k):
    """Resolve block sizes: explicit args win; otherwise the
    TPUJOB_FLASH_BLOCK_Q/K env (the JAX package's contract: a positive
    multiple of 8 for Q; for K a superset of it, a positive multiple of 64
    rather than of 128, so that a tuned key tile of 64 can travel through
    the env; every value JAX accepts is accepted); otherwise 128.  A bad
    env value fails here, naming the variable."""
    if block_q is None:
        block_q = _env_block("TPUJOB_FLASH_BLOCK_Q", 8)
    if block_k is None:
        block_k = _env_block("TPUJOB_FLASH_BLOCK_K", 64)
    return block_q, block_k


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the card's reference in chip_smoke.py):
# in f32, or in f64 given f64 tensors (the exact reference f32 dk/dv is
# held against in the card's tests)


def _wide(x):
    """x in the plain versions' precision: f32, or f64 as it is."""
    return x if x.dtype == torch.float64 else x.float()


def _scores(q, k, scale: float, causal: bool, window: Optional[int],
            sink: int):
    """Masked f32 scores [B, H, Tq, Tk] (masked entries at NEG_INF); k at
    q's head count."""
    logits = torch.einsum("bhqd,bhkd->bhqk", _wide(q), _wide(k)) * scale
    if causal:
        t_q, t_k = logits.shape[-2:]
        rows = torch.arange(t_q, device=q.device)[:, None]
        cols = torch.arange(t_k, device=q.device)[None, :]
        keep = rows >= cols
        if window is not None:
            near = rows - cols < window
            if sink:
                near = near | (cols < sink)
            keep = keep & near
        logits = logits.masked_fill(~keep, NEG_INF)
    return logits


def attention_lse(q, k, v, *, causal: bool = True,
                  scale: Optional[float] = None,
                  window: Optional[int] = None, sink: int = 0):
    """Closed-form (o, lse [B, H, T] f32): the counterpart of
    `xla_attention_lse`.  k/v carry q's head count."""
    window = check_window(causal, window)
    sink = check_sink(window, sink)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = _scores(q, k, scale, causal, window, sink)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None]).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v).to(q.dtype)
    return out, lse


def attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
              window: Optional[int] = None, sink: int = 0):
    """Plain attention output (k/v at q's head count)."""
    return attention_lse(q, k, v, causal=causal, scale=scale, window=window,
                         sink=sink)[0]


def _probs_and_ds(q, kw, vw, do, lse, delta, scale, causal, window, sink):
    """p = exp(s - lse) and ds = p (dO V^T - delta), in f32, from the
    forward's lse: what the two backward kernels rebuild tile by tile."""
    s = _scores(q, kw, scale, causal, window, sink)
    p = torch.exp(s - _wide(lse)[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", _wide(do), _wide(vw))
    return p, p * (dp - _wide(delta)[..., None])


def backward_dq_plain(q, k, v, do, lse, delta, *, scale: float,
                      causal: bool, window: Optional[int], sink: int):
    """Plain version of the dq kernel: dq = scale * ds K."""
    kw, vw = repeat_kv(q, k, v)
    _, ds = _probs_and_ds(q, kw, vw, do, lse, delta, scale, causal, window,
                          sink)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, _wide(kw)) * scale).to(
        q.dtype)


def backward_dkv_plain(q, k, v, do, lse, delta, *, scale: float,
                       causal: bool, window: Optional[int], sink: int):
    """Plain version of the dk/dv kernel: dk = scale * ds^T Q and
    dv = p^T dO, summed over each KV head's query group."""
    kw, vw = repeat_kv(q, k, v)
    p, ds = _probs_and_ds(q, kw, vw, do, lse, delta, scale, causal, window,
                          sink)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, _wide(q)) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, _wide(do))
    b, kv_heads, t, d = k.shape
    group = q.shape[1] // kv_heads
    dk = dk.reshape(b, kv_heads, group, t, d).sum(2)
    dv = dv.reshape(b, kv_heads, group, t, d).sum(2)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers

# the element types the kernels take, by their code at the C interface
DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
# The "class" of every head dim above 256, which has no compile-time head
# dim: the sliced kernels (csrc: fwd_sliced_kernel, dq_sliced_kernel,
# dkv_sliced_kernel and the forward's f32 counterpart), each of whose blocks
# writes one SLICE-column slice of its outputs and streams the head dim
# through shared memory in 64-column chunks, so that no head dim is too
# wide for them.
SLICED = 0
SLICE = 256
# The cluster route: above head dim 256 up to CLUSTER_LD (two to four
# slices) in bf16 and fp16, dq and dk/dv take the cluster kernels (csrc:
# dq_cluster_kernel, dkv_cluster_kernel, whose CLUSTER_REACH is the same
# bound), chosen by the stored head dim alone (`cluster_route`): the blocks
# of one row or key tile's slices form a thread-block cluster that splits
# the head dim's contraction, sums the partial S and dP across its blocks
# in slice order, and so computes them once, where the sliced kernels
# recompute them in every slice.  Above the reach (and in f32) the sliced
# kernels run.  CLUSTER is the route's key in INSTANTIATED.
CLUSTER_LD = 1024
CLUSTER = -1
# The pair route: above head dim 256 up to PAIR_LD in bf16 and fp16 the
# forward takes the pair kernel (csrc: fwd_pair_kernel, whose PAIR_REACH is
# the same bound), chosen by the stored head dim alone (`pair_route`): one
# block a 64-row tile, whose two consumer warpgroups split the head dim,
# each contracting its half into a partial S and adding the other's
# through shared memory, so S is computed once, where the sliced forward
# recomputes it in every slice.  Above the reach (and in f32) the sliced
# forward runs.  PAIR is the route's key in INSTANTIATED; `resolve_tiles`
# keeps the sliced forward's tile there and `launch_tiles` gives the
# tiles the kernels launch.
PAIR_LD = 512
PAIR = -2
# The tiles the tensor-core kernels are instantiated for, the same table as
# csrc/flash_attention.cu's dispatchers (the encoders' kernels' tiles are
# SHORT's, below): per kernel and head-dim class
# (64 holds head dims up to 64, 128 those up to 128, 256 those up to 256,
# SLICED every one above), the values of (rows per block, step of the
# reduction loop).  The forward and dq take rows from block_q and the key
# step from block_k; dk/dv takes key rows from block_k and the query step
# from block_q (the JAX kernels' meaning of the two numbers).  At 256, the forward's and dq's 128 rows are
# two warpgroups of 64 over a 64-key step (the forward's taken longest
# first: `fwd_chunk`), and dk/dv's 64 key rows are shared by two
# warpgroups, one holding dV and one dK (its grid split over the query
# heads: `dkv_splits`).  SLICED has one tile each, the 256 class's default
# plan: 128 rows in two warpgroups over 64-key steps (the forward, dq), 64
# keys shared by two warpgroups over 64-query steps (dk/dv, which walks
# each KV head's query-head group inside the block).  CLUSTER (bf16 and
# fp16 only) has one tile each: 64 rows whose two warpgroups take the
# 64-key steps in turns (dq), 64 keys shared by two warpgroups over
# 64-query steps (dk/dv).  PAIR (the forward, bf16 and fp16 only) has
# one tile: 64 rows over 64-key steps.
INSTANTIATED = {
    "fwd": {64: ((64, 128), (64, 128)), 128: ((64, 128), (64,)),
            256: ((64, 128), (64,)), SLICED: ((128,), (64,)),
            PAIR: ((64,), (64,))},
    "dq": {64: ((64, 128), (64, 128)), 128: ((64, 128), (64,)),
           256: ((128,), (64,)), SLICED: ((128,), (64,)),
           CLUSTER: ((64,), (64,))},
    "dkv": {64: ((64, 128), (32, 64)), 128: ((64, 128), (32,)),
            256: ((64,), (64,)), SLICED: ((64,), (64,)),
            CLUSTER: ((64,), (64,))},
}
# the f32 forward's one tile, for every block size
F32_TILE = (64, 32)
# f32 dq and dk/dv run on the tensor cores in three TF32 passes at every
# head dim (csrc: dq_tf32_kernel, dkv_tf32_kernel): 64 rows a block (query
# rows for dq, keys for dk/dv), two warpgroups over them (dq: one forming
# S and P, the other dP and dS, each then holding half of dq's columns;
# dk/dv: one forming S^T, P^T and dV, the other dP^T, dS^T and dK), over
# steps of 32 (keys for dq, queries for dk/dv) at head-dim classes 64 and
# 128 and of 16 at 256 (where the resident operands and two stages of the
# streamed ones fill the SM's shared memory) and above 256, where up to
# head dim TF32_LD (csrc's TF32_REACH) the blocks of a row or key tile's
# 256-column slices form a cluster that splits the contraction and sums
# it across its blocks in slice order, so it is computed once, and above
# it each slice's block contracts the whole head dim itself.  Their tiles
# by route (`route`), for every block size, one table (dq's rows are
# queries and its step keys, dk/dv's the other way round):
TF32_LD = 2048
F32_DKV = {64: (64, 32), 128: (64, 32), 256: (64, 16), CLUSTER: (64, 16),
           SLICED: (64, 16)}
F32_DQ = F32_DKV
# The encoders' route (`short_route`): at head-dim class 64 in bf16 and
# fp16 a call of T <= SHORT_T takes the forward, dq and dk/dv kernels that
# walk whole heads over a persistent grid (csrc: fwd_short_kernel,
# dq_short_kernel, dkv_short_kernel), whatever its blocks; their one tile
# each, as (rows, step): a head's up to 256 query rows over 128-key steps
# (the forward) or 64-key steps (dq), and its up to 256 key rows over
# 64-query steps (dk/dv).
SHORT_T = 256
SHORT = {"fwd": (256, 128), "dq": (256, 64), "dkv": (256, 64)}


class Tiles(NamedTuple):
    """(rows per block, step) of each kernel."""
    fwd: Tuple[int, int]
    dq: Tuple[int, int]
    dkv: Tuple[int, int]


def head_class(head_dim: int) -> int:
    """The head-dim class a head dim runs on: the smallest of 64, 128 and
    256 that holds it, and SLICED above 256."""
    if head_dim < 1:
        raise ValueError(
            f"flash attention kernels take head_dim >= 1, got {head_dim}")
    return next((dc for dc in (64, 128, 256) if head_dim <= dc), SLICED)


def n_slices(head_dim: int) -> int:
    """The column slices of SLICE the sliced kernels cut a head dim's
    outputs into (its blocks per row tile); 1 at the classes."""
    return -(-head_dim // SLICE)


def cluster_route(head_dim: int, dtype) -> bool:
    """Whether dq and dk/dv take the cluster kernels: bf16 or fp16 at a
    head dim above 256 up to CLUSTER_LD (the stored head dim, a multiple of
    8, has the same bound).  Their cluster is `n_slices(head_dim)` blocks,
    one per slice."""
    return (dtype in (torch.bfloat16, torch.float16)
            and SLICE < head_dim <= CLUSTER_LD)


def pair_route(head_dim: int, dtype) -> bool:
    """Whether the forward takes the pair kernel: bf16 or fp16 at a head
    dim above 256 up to PAIR_LD (the stored head dim, a multiple of 8, has
    the same bound)."""
    return (dtype in (torch.bfloat16, torch.float16)
            and SLICE < head_dim <= PAIR_LD)


def route(kernel: str, head_dim: int, dtype) -> int:
    """The key of INSTANTIATED (and of `instantiations()`) whose kernel a
    call of `kernel` ("fwd", "dq" or "dkv") launches: CLUSTER on the
    cluster routes (`cluster_route`, and f32 dq and dk/dv above head dim
    256 up to TF32_LD), PAIR on the pair route, else the head-dim class
    (SLICED above 256)."""
    if kernel != "fwd" and cluster_route(head_dim, dtype):
        return CLUSTER
    if (kernel != "fwd" and dtype == torch.float32
            and SLICE < head_dim <= TF32_LD):
        return CLUSTER
    if kernel == "fwd" and pair_route(head_dim, dtype):
        return PAIR
    return head_class(head_dim)


def scales_first(scale: float) -> bool:
    """Whether the forward kernel scales the scores before their row max
    (its SCALED instantiation).  The other route takes the max of the raw
    scores and scales it after, the max of the scaled scores only for a
    positive scale, so every other scale (negative, 0, NaN) scales first;
    that route adds a multiply per score, which the positive one, bound by
    its softmax at head_dim 64, is spared."""
    return not scale > 0


def _pick(request: int, values) -> int:
    below = [x for x in values if x <= request]
    return max(below) if below else min(values)


def short_route(head_dim: int, t: int, dtype) -> bool:
    """Whether a call takes the encoders' forward, dq and dk/dv kernels:
    head dims up to 64 (class 64) in bf16 or fp16 at T <= 256, where a
    head's Q, K and V fit a shared-memory stage and the tiled kernels, a
    block for every (b*h, row tile), paid their set-up and first loads once
    for every two key tiles (ViT-B/16 at T 197, BERT-base at T 128: PERF.md
    §6).  Above 256, at wider heads and in f32, the tiled kernels run."""
    return (dtype in (torch.bfloat16, torch.float16) and t <= SHORT_T
            and head_class(head_dim) == 64)


@functools.lru_cache(maxsize=None)  # per launch: keep the host's share small
def resolve_tiles(block_q: int, block_k: int, head_dim: int,
                  dtype, t: Optional[int] = None) -> Tiles:
    """The instantiated tiles a pair of block sizes runs on: for each knob
    the largest instantiated value <= the request, or the smallest one if
    none is.  Any pair maps, so every value the env contract takes runs;
    the default (128, 128) keeps the tiles the kernels were tuned at.  f32
    has one tile a kernel and route (F32_TILE, F32_DQ, F32_DKV).  Given the
    sequence length t, a call on the encoders'
    route (`short_route`) takes SHORT's tiles for all three kernels
    whatever its blocks; without t, the tiled kernels' tiles.  On the
    cluster route (`cluster_route`) dq and dk/dv take CLUSTER's tiles."""
    if dtype == torch.float32:
        return Tiles(F32_TILE, F32_DQ[route("dq", head_dim, dtype)],
                     F32_DKV[route("dkv", head_dim, dtype)])
    dc = head_class(head_dim)
    fwd_rows, fwd_steps = INSTANTIATED["fwd"][dc]
    dq_rows, dq_steps = INSTANTIATED["dq"][dc]
    dkv_rows, dkv_steps = INSTANTIATED["dkv"][dc]
    tiles = Tiles(fwd=(_pick(block_q, fwd_rows), _pick(block_k, fwd_steps)),
                  dq=(_pick(block_q, dq_rows), _pick(block_k, dq_steps)),
                  dkv=(_pick(block_k, dkv_rows), _pick(block_q, dkv_steps)))
    if t is not None and short_route(head_dim, t, dtype):
        tiles = tiles._replace(**SHORT)
    if cluster_route(head_dim, dtype):
        (dq_rows,), (dq_step,) = INSTANTIATED["dq"][CLUSTER]
        (dkv_rows,), (dkv_step,) = INSTANTIATED["dkv"][CLUSTER]
        tiles = tiles._replace(dq=(dq_rows, dq_step),
                               dkv=(dkv_rows, dkv_step))
    return tiles


def launch_tiles(block_q: int, block_k: int, head_dim: int, dtype,
                 t: Optional[int] = None) -> Tiles:
    """The tiles the three kernels launch: `resolve_tiles`', but the pair
    kernel's one tile for the forward on the pair route (`pair_route`)."""
    tiles = resolve_tiles(block_q, block_k, head_dim, dtype, t)
    if pair_route(head_dim, dtype):
        (rows,), (step,) = INSTANTIATED["fwd"][PAIR]
        tiles = tiles._replace(fwd=(rows, step))
    return tiles


def dkv_splits(bkv: int, t: int, group: int, sms: int) -> int:
    """How many slices dk/dv splits each KV head's query-head group into
    at head-dim class 256 (every dtype): one block per (b*kv_head, 64-key
    tile, slice),
    the fewest slices that give each of `sms` SMs a block, at most one a
    query head.  Launched heaviest first, that many already balance the
    causal walk; more only add f32 partials and blocks (Gemma 2B's
    attention: 1, 2, 3, 4 and 8 slices measured in PERF.md).  One slice (a
    group of 1, or a grid already that full) writes dk and dv directly;
    more write f32 partials that `dkv_reduce` sums.  A slice need not
    divide the group (6 heads over 5 slices: 1, 1, 1, 1, 2)."""
    blocks = bkv * -(-t // 64)
    return max(1, min(group, -(-sms // blocks)))


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fwd_chunk(bh: int, group: int, t: int, l2_bytes: int) -> int:
    """How many b*h rows the forward at head-dim class 256 (128-row tiles)
    takes longest first together: as many whole KV groups as keep the K
    and V their KV heads read (T x 256 16-bit values each) within a sixth
    of L2, at least one group, at most all rows.
    Longest first over every row evens out the causal tail (Gemma 2B's
    attention: 68 key steps on the busiest SM against 86 with each b*h's
    tiles adjacent, and all 4 of its KV heads, 8 MB, fit); where K and V
    do not stay in L2, fewer heads in flight read them from L2 more often
    (Gemma 7B's widths, 64 KV heads at B 4: a chunk of 4 against 1, 2, 6,
    12 and 64 measured, PERF.md)."""
    kv_heads = max(1, l2_bytes // 6 // (2 * t * 256 * 2))
    return min(bh, kv_heads * group)


@functools.lru_cache(maxsize=None)
def l2_bytes(device) -> int:
    return torch.cuda.get_device_properties(device).L2_cache_size


def instantiations() -> set:
    """Every built kernel as (kernel, dtype, head-dim class, rows, step)."""
    out = set()
    for kernel, classes in INSTANTIATED.items():
        for dc, (rows, steps) in classes.items():
            for dtype in ("bfloat16", "float16"):
                out.update((kernel, dtype, dc, r, s) for r in rows
                           for s in steps)
            if kernel == "fwd" and dc != PAIR:
                out.add((kernel, "float32", dc) + F32_TILE)
    for kernel, tiles in (("dq", F32_DQ), ("dkv", F32_DKV)):
        out.update((kernel, "float32", key) + tile
                   for key, tile in tiles.items())
    for kernel, tile in SHORT.items():
        out.update((kernel, dtype, 64) + tile
                   for dtype in ("bfloat16", "float16"))
    return out


_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.library()
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        mask = [f32, i32, i32, i32, ptr]  # scale, causal, window, sink, stream
        # b*h, heads, kv_heads, T, head_dim, dtype, rows, step (and the
        # forward's route and chunk)
        lib.fa_forward.argtypes = [ptr] * 5 + [i32] * 10 + mask
        lib.fa_backward_dq.argtypes = [ptr] * 7 + [i32] * 8 + mask
        # (dk/dv: and its workspace pointer, and the slices after the step)
        lib.fa_backward_dkv.argtypes = [ptr] * 9 + [i32] * 9 + mask
        lib.fa_dkv_reduce.argtypes = [ptr] * 3 + [ctypes.c_longlong, i32,
                                                  i32, f32, ptr]
        for fn in (lib.fa_forward, lib.fa_backward_dq, lib.fa_backward_dkv,
                   lib.fa_dkv_reduce):
            fn.restype = i32
        lib.fa_error_string.argtypes = [i32]
        lib.fa_error_string.restype = ctypes.c_char_p
        lib.fa_cluster_info.argtypes = [i32, i32, i32, ptr, ptr]
        lib.fa_cluster_info.restype = i32
        _lib = lib
    return _lib


def _check(err: int, name: str) -> None:
    if err:
        msg = _library().fa_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def cluster_info(kernel: str, dtype, head_dim: int) -> Tuple[int, int]:
    """(shared-memory bytes a block takes, clusters the card holds at
    once: cudaOccupancyMaxActiveClusters) of the cluster kernel of
    `kernel` ("dq" or "dkv") at a head dim on its CLUSTER route (bf16 and
    fp16 up to CLUSTER_LD, f32 up to TF32_LD)."""
    if route(kernel, head_dim, dtype) != CLUSTER or head_dim % 8:
        raise ValueError(f"no cluster kernel at head_dim {head_dim}, "
                         f"{dtype}")
    smem, clusters = ctypes.c_int(), ctypes.c_int()
    _check(_library().fa_cluster_info(
        {"dq": 0, "dkv": 1}[kernel], DTYPES[dtype], head_dim,
        ctypes.byref(smem), ctypes.byref(clusters)), f"{kernel} cluster info")
    return smem.value, clusters.value


def _check_cuda(q, k, v, do=None, lse=None, delta=None) -> None:
    """Raise on anything the kernels do not take.  Reads only shapes,
    dtypes and layouts, so it runs on tensors of any device."""
    b, heads, t, d = q.shape
    same = [q, k, v] + ([do] if do is not None else [])
    rows = [x for x in (lse, delta) if x is not None]
    for x in same + rows:
        if x.device != q.device:
            raise ValueError("flash attention inputs must share one device")
        if not x.is_contiguous():
            raise ValueError("flash attention kernels take contiguous "
                             "tensors")
        if x.data_ptr() % 16:
            raise ValueError("flash attention kernels need 16-byte aligned "
                             "tensors")
    if q.dtype not in DTYPES or any(x.dtype != q.dtype for x in same):
        raise ValueError(
            "flash attention kernels take bfloat16, float16 or float32, one "
            f"dtype for q, k, v and dO; got {[x.dtype for x in same]}")
    for x in rows:
        if x.dtype != torch.float32 or x.shape != (b, heads, t):
            raise ValueError(f"lse/delta must be float32 [{b}, {heads}, {t}]"
                             f", got {x.dtype} {tuple(x.shape)}")
    head_class(d)
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (t, d):
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if do is not None and do.shape != q.shape:
        raise ValueError(f"dO shape {tuple(do.shape)} != q shape "
                         f"{tuple(q.shape)}")
    if t < 1:
        raise ValueError("flash attention needs seq len >= 1")
    # the grid: b*heads x row tiles of at least 64 rows
    # (and above head_dim 256 one block per column slice of each tile; on
    # the cluster route the slices of a tile are one cluster, so the grid
    # is whole clusters)
    if b * heads * -(-t // 64) * n_slices(d) > 2**31 - 1:
        raise ValueError(f"batch*heads {b * heads} x seq len {t} x "
                         f"{n_slices(d)} column slice(s) exceeds the kernels'"
                         " grid of 2^31 - 1 blocks of 64 rows")


def _padded(*xs):
    """The tensors with the head dim zero-padded up to a multiple of 8, the
    row stride the kernels' TMA needs (16 bytes); zero columns add nothing
    to Q K^T or dO V^T, and the outputs' extra columns are sliced off
    (`_unpadded`)."""
    pad = -xs[0].shape[-1] % 8
    if not pad:
        return xs
    return tuple(torch.nn.functional.pad(x, (0, pad)) for x in xs)


def _unpadded(x, head_dim: int):
    return x if x.shape[-1] == head_dim else x[..., :head_dim]


def _shape_args(q, k, head_dim: int, tile) -> list:
    _, heads, t, _ = q.shape
    return [heads, k.shape[1], t, head_dim, DTYPES[q.dtype], *tile]


def _mask_args(scale, causal, window, sink, device):
    return [ctypes.c_float(scale), int(causal), int(window or 0), int(sink),
            torch.cuda.current_stream(device).cuda_stream]


def flash_forward(q, k, v, *, scale: float, causal: bool,
                  window: Optional[int], sink: int,
                  block_q: Optional[int] = None,
                  block_k: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B, H, T, D], lse [B, H, T] f32).  Replaces the TPU `_fwd_kernel`.
    Rows per block from block_q, key step from block_k (`resolve_tiles`),
    or a whole head a work item on the encoders' route (`short_route`), or
    above head_dim 256 a 256-column slice of a row tile a block, but up to
    PAIR_LD in bf16 and fp16 (`pair_route`) a 64-row tile, the head dim
    split between the block's two warpgroups (`launch_tiles`)."""
    if q.device.type == "cpu":
        return attention_lse(q, *repeat_kv(q, k, v), causal=causal,
                             scale=scale, window=window, sink=sink)
    _check_cuda(q, k, v)
    block_q, block_k = default_blocks(block_q, block_k)
    b, heads, t, d = q.shape
    tile = launch_tiles(block_q, block_k, d, q.dtype, t).fwd
    qp, kp, vp = _padded(q, k, v)
    o = torch.empty_like(qp)
    lse = torch.empty((b, heads, t), device=q.device, dtype=torch.float32)
    chunk = fwd_chunk(b * heads, heads // k.shape[1], t, l2_bytes(q.device))
    with torch.cuda.device(q.device):
        err = _library().fa_forward(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b * heads,
            *_shape_args(q, k, qp.shape[-1], tile), int(scales_first(scale)),
            chunk, *_mask_args(scale, causal, window, sink, q.device))
    _check(err, "flash forward")
    flash_forward.launches += 1
    flash_forward.short_launches += tile == SHORT["fwd"]
    flash_forward.sliced_launches += head_class(d) == SLICED
    flash_forward.pair_launches += pair_route(d, q.dtype)
    return _unpadded(o, d), lse


def flash_backward_dq(q, k, v, do, lse, delta, *, scale: float, causal: bool,
                      window: Optional[int], sink: int,
                      block_q: Optional[int] = None,
                      block_k: Optional[int] = None):
    """dq [B, H, T, D].  Replaces the TPU `_bwd_dq_kernel`.  Rows per block
    from block_q, key step from block_k, or a whole KV head's query heads a
    work item on the encoders' route (`short_route`), or above head_dim 256
    a 256-column slice of a row tile a block: up to CLUSTER_LD in bf16 and
    fp16 (`cluster_route`) the cluster kernel's 64 rows, and up to TF32_LD
    in f32, the slices of a row tile one cluster.  f32 runs on the tensor
    cores in three TF32 passes at every head dim."""
    if q.device.type == "cpu":
        return backward_dq_plain(q, k, v, do, lse, delta, scale=scale,
                                 causal=causal, window=window, sink=sink)
    _check_cuda(q, k, v, do, lse, delta)
    block_q, block_k = default_blocks(block_q, block_k)
    b, heads, t, d = q.shape
    tile = resolve_tiles(block_q, block_k, d, q.dtype, t).dq
    qp, kp, vp, dop = _padded(q, k, v, do)
    dq = torch.empty_like(qp)
    with torch.cuda.device(q.device):
        err = _library().fa_backward_dq(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), dop.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b * heads,
            *_shape_args(q, k, qp.shape[-1], tile),
            *_mask_args(scale, causal, window, sink, q.device))
    _check(err, "flash dq")
    flash_backward_dq.launches += 1
    flash_backward_dq.short_launches += tile == SHORT["dq"]
    flash_backward_dq.sliced_launches += head_class(d) == SLICED
    flash_backward_dq.cluster_launches += route("dq", d, q.dtype) == CLUSTER
    return _unpadded(dq, d)


def flash_backward_dkv(q, k, v, do, lse, delta, *, scale: float,
                       causal: bool, window: Optional[int], sink: int,
                       block_q: Optional[int] = None,
                       block_k: Optional[int] = None):
    """(dk, dv) at k's head count.  Replaces the TPU `_bwd_dkv_kernel`.
    Key rows per block from block_k, query step from block_q, or a whole KV
    head a work item on the encoders' route (`short_route`).  At head-dim
    class 256 each KV head's query-head group is split into `dkv_splits`
    slices over the grid; with more than one the kernel writes f32
    partials to a workspace that `dkv_reduce` sums.
    Above head_dim 256 a block takes a 256-column slice of a key tile's dk
    and dv and walks the whole group itself; up to CLUSTER_LD in bf16 and
    fp16 (`cluster_route`), and up to TF32_LD in f32, the slices of a key
    tile are one cluster.  f32 runs on the tensor cores in three TF32
    passes at every head dim."""
    if q.device.type == "cpu":
        return backward_dkv_plain(q, k, v, do, lse, delta, scale=scale,
                                  causal=causal, window=window, sink=sink)
    _check_cuda(q, k, v, do, lse, delta)
    block_q, block_k = default_blocks(block_q, block_k)
    b, heads, t, d = q.shape
    kv_heads = k.shape[1]
    tile = resolve_tiles(block_q, block_k, d, q.dtype, t).dkv
    qp, kp, vp, dop = _padded(q, k, v, do)
    splits = 1
    if head_class(d) == 256:
        splits = dkv_splits(b * kv_heads, t, heads // kv_heads,
                            sm_count(q.device))
    if splits > 1:
        dk = dv = None
        ws = torch.empty((2, splits, *kp.shape), device=q.device,
                         dtype=torch.float32)
    else:
        dk, dv, ws = torch.empty_like(kp), torch.empty_like(vp), None
    with torch.cuda.device(q.device):
        err = _library().fa_backward_dkv(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), dop.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            *(None if x is None else x.data_ptr() for x in (dk, dv, ws)),
            b * kv_heads, *_shape_args(q, k, qp.shape[-1], tile), splits,
            *_mask_args(scale, causal, window, sink, q.device))
    _check(err, "flash dk/dv")
    flash_backward_dkv.launches += 1
    flash_backward_dkv.short_launches += tile == SHORT["dkv"]
    flash_backward_dkv.sliced_launches += head_class(d) == SLICED
    flash_backward_dkv.cluster_launches += (route("dkv", d, q.dtype)
                                            == CLUSTER)
    if ws is not None:
        dk, dv = dkv_reduce(ws, scale, q.dtype)
    return _unpadded(dk, d), _unpadded(dv, d)


def dkv_reduce_plain(ws, scale: float, dtype):
    """Plain version of the reduce kernel: (scale * the sum of ws[0]'s
    slices, the sum of ws[1]'s) in `dtype`, each sum taken in slice order
    in f32, as the kernel takes it."""
    dk, dv = ws[0, 0], ws[1, 0]
    for s in range(1, ws.shape[1]):
        dk, dv = dk + ws[0, s], dv + ws[1, s]
    return (dk * scale).to(dtype), dv.to(dtype)


def dkv_reduce(ws, scale: float, dtype):
    """(dk, dv) from dk/dv's f32 slice partials ws [2, splits, ...] (dK's,
    then dV's): dk = scale * their sum, dv = the sum, in `dtype` (bf16,
    fp16 or f32).  Replaces no TPU kernel: the Pallas dk/dv kernel carries the GQA
    group's sum in VMEM scratch along its sequential grid."""
    if ws.device.type == "cpu":
        return dkv_reduce_plain(ws, scale, dtype)
    if (ws.dtype != torch.float32 or not ws.is_contiguous() or ws.dim() < 3
            or ws.shape[0] != 2 or ws.shape[1] < 2 or dtype not in DTYPES
            or ws[0, 0].numel() % 4):
        raise ValueError(
            "dkv_reduce takes a contiguous f32 [2, splits >= 2, ...] "
            "workspace of a multiple of 4 elements a slice, into bfloat16, "
            f"float16 or float32; got {ws.dtype} {tuple(ws.shape)} into "
            f"{dtype}")
    dk = torch.empty(ws.shape[2:], device=ws.device, dtype=dtype)
    dv = torch.empty_like(dk)
    with torch.cuda.device(ws.device):
        err = _library().fa_dkv_reduce(
            ws.data_ptr(), dk.data_ptr(), dv.data_ptr(), dk.numel(),
            ws.shape[1], DTYPES[dtype], ctypes.c_float(scale),
            torch.cuda.current_stream(ws.device).cuda_stream)
    _check(err, "dk/dv reduce")
    dkv_reduce.launches += 1
    return dk, dv


# the three kernels every attention path launches once a call each;
# dkv_reduce runs besides dk/dv only where it is split (head-dim class 256).
# Each of the three has a second kernel, the encoders' (`short_route`),
# whose launches `short_launches` counts apart, and a third, the sliced
# kernel of head dims above 256, counted apart in `sliced_launches` (and
# `launches` counts them all).  Of those, dq's and dk/dv's launches on
# their CLUSTER route (`route`: the cluster kernels' in bf16 and fp16, the
# tensor-core kernels' clusters in f32) are counted again in
# `cluster_launches`, and the forward's on the pair route (`pair_route`)
# are the pair kernel's, counted again in `pair_launches`.  dq's and
# dk/dv's in f32 are all the tensor-core kernels' (dq_tf32_kernel,
# dkv_tf32_kernel).
KERNELS = (flash_forward, flash_backward_dq, flash_backward_dkv)
CLUSTER_KERNELS = (flash_backward_dq, flash_backward_dkv)
PAIR_KERNELS = (flash_forward,)


def reset_launches() -> None:
    for fn in KERNELS + (dkv_reduce,):
        fn.launches = 0
    for fn in KERNELS:
        fn.short_launches = 0
        fn.sliced_launches = 0
    for fn in CLUSTER_KERNELS:
        fn.cluster_launches = 0
    for fn in PAIR_KERNELS:
        fn.pair_launches = 0


reset_launches()


def launches() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def short_launches() -> dict:
    return {fn.__name__: fn.short_launches for fn in KERNELS}


def sliced_launches() -> dict:
    return {fn.__name__: fn.sliced_launches for fn in KERNELS}


def cluster_launches() -> dict:
    return {fn.__name__: fn.cluster_launches for fn in CLUSTER_KERNELS}


def pair_launches() -> dict:
    return {fn.__name__: fn.pair_launches for fn in PAIR_KERNELS}


class FlashAttentionFn(torch.autograd.Function):
    """The kernels' gradient: the forward saves (q, k, v, o, lse); the
    backward forms delta = rowsum(dO * O) in f32 and launches dq and
    dk/dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k, window, sink):
        o, lse = flash_forward(q, k, v, scale=scale, causal=causal,
                               window=window, sink=sink, block_q=block_q,
                               block_k=block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(scale=scale, causal=causal, window=window, sink=sink)
        ctx.blocks = (block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        block_q, block_k = ctx.blocks
        g = g.contiguous()
        delta = (g.float() * o.float()).sum(-1)
        dq = flash_backward_dq(q, k, v, g, lse, delta, block_q=block_q,
                               block_k=block_k, **ctx.opts)
        dk, dv = flash_backward_dkv(q, k, v, g, lse, delta, block_q=block_q,
                                    block_k=block_k, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


class FlashAttentionLseFn(torch.autograd.Function):
    """(o, lse) through the same kernels, differentiable in both outputs.
    The lse cotangent folds into the backward kernels' row scalar:
    ds = p (dp - delta + dlse) = p (dp - delta'), since d lse_i / d s_ij =
    p_ij, so dq and dk/dv are launched with delta' = rowsum(dO * O) - dlse
    and need no change.  An output that the caller does not use gets no
    cotangent (None) and counts as zeros."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k):
        o, lse = flash_forward(q, k, v, scale=scale, causal=causal,
                               window=None, sink=0, block_q=block_q,
                               block_k=block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.set_materialize_grads(False)
        ctx.opts = dict(scale=scale, causal=causal, window=None, sink=0)
        ctx.blocks = (block_q, block_k)
        return o, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        block_q, block_k = ctx.blocks
        g = torch.zeros_like(o) if g is None else g.contiguous()
        delta = (g.float() * o.float()).sum(-1)
        if g_lse is not None:
            delta = delta - g_lse.float()
        dq = flash_backward_dq(q, k, v, g, lse, delta, block_q=block_q,
                               block_k=block_k, **ctx.opts)
        dk, dv = flash_backward_dkv(q, k, v, g, lse, delta, block_q=block_q,
                                    block_k=block_k, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def _route(q) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, got "
                         f"{q.device}")
    return q.device.type


def flash_attention(q, k, v, causal=True, scale=None, block_q=None,
                    block_k=None, window=None, sink=0):
    """Fused attention: the CUDA kernels (forward and backward) on a CUDA
    tensor, the plain version under ordinary autograd on a CPU tensor.

    `window` (sliding window, requires causal) restricts each query to its
    last `window` keys; `sink` keeps the first `sink` positions visible on
    top of it.  The kernels skip every key tile outside the band."""
    window = check_window(causal, window)
    sink = check_sink(window, sink)
    check_gqa(q, k)
    s = scale if scale is not None else q.shape[-1] ** -0.5
    if _route(q) == "cpu":
        return attention(q, *repeat_kv(q, k, v), causal=causal, scale=s,
                         window=window, sink=sink)
    block_q, block_k = default_blocks(block_q, block_k)
    return FlashAttentionFn.apply(q, k, v, causal, s, block_q, block_k,
                                  window, sink)


def flash_attention_lse(q, k, v, causal=True, scale=None, block_q=None,
                        block_k=None):
    """(o, lse [B, H, T] f32), differentiable in both outputs: the
    counterpart of the JAX `flash_attention_lse`, the hop primitive of ring
    attention.  The CUDA kernels on a CUDA tensor (`FlashAttentionLseFn`),
    the plain `attention_lse` under ordinary autograd on a CPU tensor.  k/v
    may carry fewer (grouped-query) heads than q."""
    check_gqa(q, k)
    s = scale if scale is not None else q.shape[-1] ** -0.5
    if _route(q) == "cpu":
        return attention_lse(q, *repeat_kv(q, k, v), causal=causal, scale=s)
    block_q, block_k = default_blocks(block_q, block_k)
    return FlashAttentionLseFn.apply(q, k, v, causal, s, block_q, block_k)
