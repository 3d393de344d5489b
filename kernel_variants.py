#!/usr/bin/env python3
"""Time variants of the dq flash-attention kernel against the checked-in
source, on one NVIDIA card.

    python3 kernel_variants.py

Each variant in VARIANTS is a list of (text, replacement) edits to
ops/csrc/flash_attention.cu (each text must occur exactly once).  Every
variant, and the source as checked in ("base"), is built into its own
library (printing ptxas's registers and spills for the dq kernel),
checked against dq's plain version at the LM's main-path shape (B 8,
H 12, T 2048, D 64, causal, blocks (128, 128)) with chip_smoke's
tolerance, and timed with CUDA events in turns: base, v1, ..., vn, then
the reverse, ROUNDS times.  The edits record the designs the dq kernel was chosen
from (PERF.md); a kernel's next variants replace them.
"""
from __future__ import annotations

import ctypes
import shutil
import sys
import tempfile
from pathlib import Path

import chip_smoke

ROUNDS = 4
DQ_PRODUCTS = """    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hopper::Mma<E>::ss(sc, hopper::desc_k(sQw, BM, kk),
                         hopper::desc_k(sk, BK, kk), kk > 0);
      hopper::Mma<E>::ss(dp, hopper::desc_k(sdOw, BM, kk),
                         hopper::desc_k(sv, BK, kk), kk > 0);
    }
    hopper::wg_commit();
    hopper::wg_wait();
    hopper::wg_fence_regs(sc);
    hopper::wg_fence_regs(dp);
"""
# S and dP in two commit groups: the exponentials of S run while dP is in
# flight
DQ_SPLIT = """    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Mma<E>::ss(sc, hopper::desc_k(sQw, BM, kk),
                         hopper::desc_k(sk, BK, kk), kk > 0);
    hopper::wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Mma<E>::ss(dp, hopper::desc_k(sdOw, BM, kk),
                         hopper::desc_k(sv, BK, kk), kk > 0);
    hopper::wg_commit();
    hopper::wg_wait<1>();
    hopper::wg_fence_regs(sc);
"""
DQ_DA = """    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a<E>(da[kk], dp, kk);"""
DQ_SPLIT_DA = """    hopper::wg_wait();
    hopper::wg_fence_regs(dp);
""" + DQ_DA
DQ_MASK = """    if (!tile_full(mk, r0, 64, k0, BK)) mask_tile(sc, mk, row0, k0, t);"""
# the element test of the first version: Mask::live on each element
DQ_LIVE = """    if (!tile_full(mk, r0, 64, k0, BK)) {
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) {
        const int j = k0 + 8 * (x >> 2) + 2 * t + (x & 1);
        if (!mk.live(row0 + 8 * ((x >> 1) & 1), j)) sc[x] = 0.f;
      }
    }"""
# stages (at most; shared memory may hold fewer)
DQ_STAGES = """  static constexpr int STAGES =
      cmin(WG == 2 ? 4 : 2,"""


def dq_stages(stages: str) -> str:
    return DQ_STAGES.replace("WG == 2 ? 4 : 2", stages)


# the default tile (128 query rows) at head_dim 64 run with 64-key steps
DQ_DEFAULT_TILE = """  FA_DQ(64, 128, 128)
"""
DQ_BK64 = """  if (dc == 64 && rows == 128 && step == 128)
    return dq<E, 64, 2, 64>(bh, a, st);
"""


# dQ += dS K of tile j left in flight while S and dP of tile j + 1 are
# issued; its stage is freed after the next wait (da kept live until then)
DQ_LOOP = """dq_acc[h][i] = 0.f;
  hopper::mbar_wait(q_bar, 0);
  for (int it = 0; it < n_iter; ++it) {"""
DQ_DEFER_LOOP = """dq_acc[h][i] = 0.f;
  hopper::mbar_wait(q_bar, 0);
  uint32_t da[BK / 16][4];
  for (int it = 0; it < n_iter; ++it) {"""
DQ_DEFER_ISSUE = DQ_PRODUCTS + """    if (it > 0) {
#pragma unroll
      for (int h = 0; h < D / 64; ++h) hopper::wg_fence_regs(dq_acc[h]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        asm volatile("" ::"r"(da[kk][0]), "r"(da[kk][1]), "r"(da[kk][2]),
                     "r"(da[kk][3]));
      hopper::mbar_arrive(bars + 8 * (STAGES + (it - 1) % STAGES));
    }
"""
DQ_DEFER_DA = DQ_DA.replace("    uint32_t da[BK / 16][4];\n", "")
DQ_END = """    hopper::wg_commit();
    hopper::wg_wait();
#pragma unroll
    for (int h = 0; h < D / 64; ++h) hopper::wg_fence_regs(dq_acc[h]);
    hopper::mbar_arrive(bars + 8 * (STAGES + s));
  }
"""
DQ_DEFER_END = """    hopper::wg_commit();
  }
  hopper::wg_wait();
#pragma unroll
  for (int h = 0; h < D / 64; ++h) hopper::wg_fence_regs(dq_acc[h]);
"""

VARIANTS = {
    "stages3": [(DQ_STAGES, dq_stages("WG == 2 ? 3 : 2"))],
    "stages5": [(DQ_STAGES, dq_stages("WG == 2 ? 5 : 2"))],
    "bk64": [(DQ_DEFAULT_TILE, DQ_BK64),
             (DQ_STAGES, dq_stages("WG == 2 ? 4 : 3"))],
    "live_mask": [(DQ_MASK, DQ_LIVE)],
    "split": [(DQ_PRODUCTS, DQ_SPLIT), (DQ_DA, DQ_SPLIT_DA)],
    "defer": [(DQ_LOOP, DQ_DEFER_LOOP), (DQ_PRODUCTS, DQ_DEFER_ISSUE),
              (DQ_DA, DQ_DEFER_DA), (DQ_END, DQ_DEFER_END)],
}


def build(name: str, edits, root: Path):
    from tf_operator_tpu_torch.ops import _build

    csrc = root / name
    shutil.copytree(_build.CSRC, csrc)
    source = csrc / _build.SOURCE.name
    src = source.read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: an edit's text occurs "
                               f"{src.count(old)} times")
        src = src.replace(old, new)
    source.write_text(src)
    lib = root / f"lib-{name}.so"
    log = _build.nvcc(source, lib)
    return lib, log


def report(name: str, log: str) -> None:
    """ptxas's registers and spills for the dq kernel's instantiations, and
    every warning or performance note."""
    for line in log.splitlines():
        if "warning" in line.lower() or "Performance" in line:
            print(f"  {name}: {line.strip()}")
    for inst, regs, stores, loads, _ in chip_smoke.ptxas_report(log):
        if inst.startswith("dq_kernel"):
            print(f"  {name}: {inst} {regs} registers at launch, {stores} "
                  f"bytes spill stores, {loads} bytes spill loads")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import attention as A

    print(chip_smoke.card_line(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, t, d = 8, 12, 2048, 64
    q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    opts = dict(scale=d ** -0.5, causal=True, window=None, sink=0)
    blocks = dict(block_q=128, block_k=128)
    o, lse = A.flash_forward(q, k, v, **blocks, **opts)
    delta = (do.float() * o.float()).sum(-1)

    def call():
        return A.flash_backward_dq(q, k, v, do, lse, delta, **blocks,
                                   **opts)

    ref = A.backward_dq_plain(*(x.float() for x in (q, k, v, do)), lse, delta,
                              **opts)

    libs = {}
    with tempfile.TemporaryDirectory(prefix="kernel-variants-") as tmp:
        for name, edits in [("base", [])] + list(VARIANTS.items()):
            lib, log = build(name, edits, Path(tmp))
            report(name, log)
            libs[name] = ctypes.CDLL(str(lib))
        times = {name: [] for name in libs}
        order = list(libs)
        for r in range(ROUNDS):
            for name in order if r % 2 == 0 else order[::-1]:
                A._lib = None  # the wrappers bind the variant's library
                _build.library = lambda lib=libs[name]: lib
                got = call()
                torch.cuda.synchronize()
                worst, rel = chip_smoke.tolerance_ratios(got, ref)
                held = worst <= 1.0 and rel <= chip_smoke.FRO
                ms = chip_smoke.cuda_ms(call, 20)
                times[name].append(ms)
                print(f"  round {r} {name:12s} dq ms {ms:.4f} worst "
                      f"err/limit {worst:.3f} Frobenius {rel:.2e}"
                      f"{'' if held else ' OUTSIDE THE TOLERANCE'}",
                      flush=True)
    for name, ts in times.items():
        print(f"{name:12s} dq mean ms {sum(ts) / len(ts):.4f} over "
              f"{len(ts)} ({' '.join(f'{x:.4f}' for x in ts)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
