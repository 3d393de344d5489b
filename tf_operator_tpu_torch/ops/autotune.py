"""Flash-kernel block-size autotuning: the counterpart of
`tf_operator_tpu/ops/autotune.py`.

The CUDA kernels (ops/attention.py) take block_q/block_k, which
`resolve_tiles` maps onto their instantiated tiles: the forward and dq take
their rows per block from block_q and their key step from block_k, dk/dv
its key rows from block_k and its query step from block_q.  (128, 128) is
the default; the best tiling depends on the sequence length, the head count
and the dtype.  This module measures instead of guessing: it times the
forward and backward of `flash_attention` at candidate block pairs on the
current device and returns the winner.

Tuned blocks propagate as in the reference:

- explicitly: `flash_attention(..., block_q=bq, block_k=bk)`;
- ambiently: `TPUJOB_FLASH_BLOCK_Q` / `TPUJOB_FLASH_BLOCK_K`, read by
  `default_blocks()` when callers leave the block arguments unset, so a
  workload picks up a tuned pair without plumbing through its config.

Results are cached in-process by shape signature and, when
`TPUJOB_AUTOTUNE_CACHE` names a JSON file, across processes (written by an
atomic replace).  The key carries a hash of ops/attention.py and of every
kernel source under ops/csrc/, so an edited kernel never reuses a stale
winner.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, List, Optional, Tuple

# (block_q, block_k) search space: one pair for each distinct set of tiles
# the pairs resolve to at head_dim 64 in bf16 and fp16, which reaches every
# instantiation (ops/attention.py:INSTANTIATED).  block_q 32, 64, 128 give
# forward/dq rows 64, 64, 128 and dk/dv query steps 32, 64, 64; block_k 64,
# 128 give forward/dq key steps and dk/dv key rows of 64, 128.  At head_dim
# 256 block_q 32 and 64 give forward rows 64 and 128 gives 128; dq (64,
# 64) and dk/dv (64, 32) have one tile there, which every pair reaches.
DEFAULT_CANDIDATES: List[Tuple[int, int]] = [
    (bq, bk) for bq in (32, 64, 128) for bk in (64, 128)]

# shape signature -> result dict
_CACHE: Dict[tuple, dict] = {}

# memoized kernel-source digest (None = not yet computed)
_KERNEL_HASH: Optional[str] = None


def _cache_path() -> Optional[str]:
    return os.environ.get("TPUJOB_AUTOTUNE_CACHE") or None


def _kernel_source_hash() -> str:
    """sha256 (truncated) over ops/attention.py's bytes and the kernels'
    build key (`_build.source_digest`: every file under ops/csrc/ and the
    compiler flags).  Part of every cache key: a tuned pair is only valid
    for the kernels it was measured on."""
    global _KERNEL_HASH
    if _KERNEL_HASH is None:
        from . import _build, attention

        with open(attention.__file__, "rb") as f:
            digest = hashlib.sha256(f.read())
        digest.update(_build.source_digest().digest())
        _KERNEL_HASH = digest.hexdigest()[:16]
    return _KERNEL_HASH


def _signature(backend, b, h, kv_h, t, d, causal, dtype,
               candidates, reps) -> tuple:
    # the reference's fields: the backend (a CPU run times the plain path,
    # where every candidate ties, and must never be served to a card), the
    # search (candidates, reps) and the kernel-source hash
    return (backend, b, h, kv_h, t, d, bool(causal), str(dtype),
            tuple(map(tuple, candidates)), reps, _kernel_source_hash())


def _load_persistent(sig: tuple) -> Optional[dict]:
    path = _cache_path()
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            table = json.load(f)
        return table.get(json.dumps(list(sig)))
    except (OSError, ValueError):
        return None


def _store_persistent(sig: tuple, result: dict) -> None:
    path = _cache_path()
    if not path:
        return
    table = {}
    try:
        if os.path.exists(path):
            with open(path) as f:
                table = json.load(f)
    except (OSError, ValueError):
        table = {}
    table[json.dumps(list(sig))] = result
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(table, f, indent=1)
        os.replace(tmp, path)
    except OSError:
        pass


def _backend(device) -> str:
    import torch

    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


def tune_flash_blocks(
    b: int, h: int, t: int, d: int,
    *,
    kv_h: Optional[int] = None,
    causal: bool = True,
    dtype=None,
    reps: int = 3,
    candidates: Optional[List[Tuple[int, int]]] = None,
) -> dict:
    """Time flash fwd+bwd per candidate block pair; return {"block_q",
    "block_k", "ms", "table": [{"block_q", "block_k", "tiles", "ms" |
    "error"}]}, or {"error", "table"} when no candidate ran.  Each row's
    "tiles" are the (rows, step) each kernel resolved to.

    Runs on the current CUDA device, or on the CPU where there is none:
    there `flash_attention` runs the plain path, so every candidate ties
    (the reference times XLA off the TPU the same way) and only the
    machinery is exercised.  Results are cached by shape signature
    (in-process and in the optional JSON file)."""
    import torch

    from .attention import flash_attention, launch_tiles

    dtype = dtype or torch.bfloat16
    kv_h = kv_h or h
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    candidates = candidates or DEFAULT_CANDIDATES
    sig = _signature(_backend(device), b, h, kv_h, t, d, causal,
                     str(dtype).removeprefix("torch."), candidates, reps)
    if sig in _CACHE:
        return _CACHE[sig]
    persisted = _load_persistent(sig)
    if persisted is not None:
        _CACHE[sig] = persisted
        return persisted

    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(b, n, t, d, generator=gen, device=device)
               .to(dtype).requires_grad_() for n in (h, kv_h, kv_h))

    def step(bq, bk):
        out = flash_attention(q, k, v, causal, None, bq, bk)
        return torch.autograd.grad(out.float().sum(), (q, k, v))

    def timed(fn) -> float:
        if device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) / reps * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps

    table = []
    best = None
    for bq, bk in candidates:
        if bq > t or bk > t:
            continue
        row = {"block_q": bq, "block_k": bk}
        try:
            row["tiles"] = {name: list(tile) for name, tile in
                            launch_tiles(bq, bk, d, dtype,
                                         t)._asdict().items()}
            step(bq, bk)  # warm-up (and the first launch's checks)
            ms = timed(lambda bq=bq, bk=bk: step(bq, bk))
            row["ms"] = round(ms, 4)
            if best is None or ms < best[0]:
                best = (ms, bq, bk)
        except Exception as e:  # noqa: BLE001 — recorded in the table row
            row["error"] = repr(e)[:160]
        table.append(row)
    if best is None:
        result = {"error": "no candidate ran", "table": table}
    else:
        result = {"block_q": best[1], "block_k": best[2],
                  "ms": round(best[0], 4), "table": table}
    _CACHE[sig] = result
    _store_persistent(sig, result)
    return result
