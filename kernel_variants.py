#!/usr/bin/env python3
"""Time variants of the flash-attention kernels against the checked-in
source, on one NVIDIA card.

    python3 kernel_variants.py                  # dq at head_dim 64
    python3 kernel_variants.py --d256           # dq and dk/dv at 256
    python3 kernel_variants.py --trees DIR ...  # whole trees in turns

Each variant in VARIANTS (D256_VARIANTS with --d256) is a list of (text,
replacement) edits to ops/csrc/flash_attention.cu (each text must occur
exactly once).  Every variant, and the source as checked in ("base"), is
built into its own library (printing ptxas's registers and spills for the
kernels timed), checked against the plain version with chip_smoke's
tolerance, and timed with CUDA events in turns: base, v1, ..., vn, then
the reverse, ROUNDS times.  Without flags: dq at the LM's main-path shape
(B 8, H 12, T 2048, D 64, causal, blocks (128, 128)).  With --d256: dq
and dk/dv (its reduce included) at Gemma 2B's attention (B 4, 8 query
heads of 256 over one KV head, T 2048, causal, bf16) against dq's
one-warpgroup 64-row plan and dk/dv's 32-query step, and dk/dv (on the D256_SPLITS_ON build) at
each count of slices of the query heads, beside the host's choice
(`attention.dkv_splits`), and the reduce alone.  With
--trees: chip_smoke's kernel case gemma_2b (and main) run in each tree
given (a checkout, e.g. a parent commit unpacked with `git archive` into a
git-ignored directory), one process per tree per round, in turns.  The
edits record the designs the kernels were chosen from (PERF.md); a
kernel's next variants replace them.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
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

# head-dim class 256: the kernels against the designs they replaced
# dq: the earlier plan, dq_kernel with one consumer warpgroup of 64 rows over
# 64-key steps (two 64 KB stages), run for the tile (128, 64)
D256_DQ_64ROWS = [
    ("""    FA_DQ(256, 128, 64)
""", """    if (dc == 256 && rows == 128 && step == 64)
      return dq<E, 256, 1, 64>(bh, a, st);
"""),
    ("std::conditional_t<D == 256, DqWideSmem",
     "std::conditional_t<D == 256 && WG == 2, DqWideSmem"),
    ("""  static_assert(D != 256 || (WG == 2 && BK == 64), "dq's tile at D 256");
""", ""),
    ("""    if constexpr (D == 256)
      return dq_wide_kernel<E>;""", """    if constexpr (D == 256 && WG == 2)
      return dq_wide_kernel<E>;"""),
]
# dk/dv: the earlier 32-query step (three stages; S^T and dP^T m64n32)
D256_DKV_STEP32 = [("""      return dkv<E, 256, 2, 64>(bkv, a, st);""",
                    """      return dkv<E, 256, 2, 32>(bkv, a, st);""")]
# dk/dv: the producer warp stores each tile's lse and delta itself, as
# below head_dim 256 (waiting on its loads), instead of by cp.async
D256_DKV_ROWS_SYNC = [
    ("""    if constexpr (S::SPLIT) {
      // the rows by cp.async, raw lse, 0 past T: each lane's arrival
      // completes when its copies have landed, so the warp goes on to the
      // next tile without waiting for them (32 such arrivals and lane 0's
      // below complete the stage)
      const uint32_t rows = sK + S::rows_off(s);
      for (int c = lane; c < BQ; c += 32) {
        const int i = q0 + c;
        const size_t off = (size_t)bh * T + (i < T ? i : 0);
        hopper::cp_async4(rows + 4 * c, lse + off, i < T);
        hopper::cp_async4(rows + 4 * (BQ + c), delta + off, i < T);
      }
      hopper::cp_async_mbar_arrive(bars + 8 * s);
    } else {""", """    {"""),
    ("""      // the producer's 32 lanes' row copies and lane 0's TMA bytes
      hopper::mbar_init(bars + 8 * s, 33);""",
     """      hopper::mbar_init(bars + 8 * s, 32);"""),
    ("""      dkv_probs<BQ>(x, rows, mk, q0, w.k0, key, t, sl2, LOG2E);""",
     """      dkv_probs<BQ>(x, rows, mk, q0, w.k0, key, t, sl2);"""),
]
D256_VARIANTS = {
    "dq_64rows": D256_DQ_64ROWS,
    "dkv_step32": D256_DKV_STEP32,
    "dkv_rows_sync": D256_DKV_ROWS_SYNC,
}
# the build dk/dv is timed at each count of slices on
D256_SPLITS_ON = "base"
D256_SPLITS = (1, 2, 3, 4, 8)


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


def report(name: str, log: str, d256: bool = False) -> None:
    """ptxas's registers and spills for the dq kernel's instantiations (with
    d256: those of dq and dk/dv at head-dim class 256), and every warning
    or performance note."""
    for line in log.splitlines():
        if "warning" in line.lower() or "Performance" in line:
            print(f"  {name}: {line.strip()}")
    for inst, regs, stores, loads, key in chip_smoke.ptxas_report(log):
        if (key[0] in ("dq", "dkv") and key[2] == 256 if d256
                else inst.startswith("dq_kernel")):
            print(f"  {name}: {inst} {regs} registers at launch, {stores} "
                  f"bytes spill stores, {loads} bytes spill loads")


def bind(lib) -> None:
    """Make the wrappers launch the kernels of `lib`."""
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import attention as A

    A._lib = None
    _build.library = lambda: lib


def main_d256() -> int:
    """dq and dk/dv at Gemma 2B's attention for each D256 variant, in
    turns; dk/dv at each count of slices and the reduce on the base."""
    import torch

    from tf_operator_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, hkv, t, d = 4, 8, 1, 2048, 256
    q, do = (torch.randn(b, h, t, d, generator=gen, device=dev)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, hkv, t, d, generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    opts = dict(scale=d ** -0.5, causal=True, window=None, sink=0,
                block_q=128, block_k=128)
    plain = dict(opts)
    del plain["block_q"], plain["block_k"]
    auto = A.dkv_splits(b * hkv, t, h // hkv, A.sm_count(dev))
    print(f"gemma_2b: B {b}, H {h} over {hkv} KV head, T {t}, D {d}, "
          f"causal, bf16; dk/dv slices (dkv_splits) {auto}", flush=True)

    choose = A.dkv_splits

    def calls(splits=None):
        # dk/dv at `splits` slices (None: the host's choice)
        A.dkv_splits = choose if splits is None else lambda *_: splits
        return {
            "dq": lambda: A.flash_backward_dq(q, k, v, do, lse, delta,
                                              **opts),
            "dkv": lambda: A.flash_backward_dkv(q, k, v, do, lse, delta,
                                                **opts)}

    libs = {}
    with tempfile.TemporaryDirectory(prefix="kernel-variants-") as tmp:
        for name, edits in [("base", [])] + list(D256_VARIANTS.items()):
            lib, log = build(name, edits, Path(tmp))
            report(name, log, d256=True)
            libs[name] = ctypes.CDLL(str(lib))
        bind(libs["base"])
        o, lse = A.flash_forward(q, k, v, **opts)
        delta = (do.float() * o.float()).sum(-1)
        qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
        refs = {"dq": (A.backward_dq_plain(qf, kf, vf, dof, lse, delta,
                                           **plain),),
                "dkv": A.backward_dkv_plain(qf, kf, vf, dof, lse, delta,
                                            **plain)}
        del qf, kf, vf, dof
        runs = [(name, None) for name in libs]
        runs += [(D256_SPLITS_ON, n) for n in D256_SPLITS if n != auto]
        times = {run: {} for run in runs}
        for r in range(ROUNDS):
            for name, splits in runs if r % 2 == 0 else runs[::-1]:
                bind(libs[name])
                label = name if splits is None else f"{name} {splits} sl."
                for kernel, fn in calls(splits).items():
                    if splits is not None and kernel == "dq":
                        continue
                    got = fn()
                    got = got if isinstance(got, tuple) else (got,)
                    torch.cuda.synchronize()
                    held = all(
                        chip_smoke.tolerance_ratios(x, ref)[0] <= 1.0 and
                        chip_smoke.tolerance_ratios(x, ref)[1] <=
                        chip_smoke.FRO for x, ref in zip(got, refs[kernel]))
                    ms = chip_smoke.cuda_ms(fn, 20)
                    times[(name, splits)].setdefault(kernel, []).append(ms)
                    print(f"  round {r} {label:16s} {kernel:3s} ms {ms:.4f}"
                          f"{'' if held else ' OUTSIDE THE TOLERANCE'}",
                          flush=True)
        A.dkv_splits = choose
        bind(libs["base"])
        ws = torch.randn(2, auto, b, hkv, t, d, generator=gen, device=dev)
        reduce_ms = chip_smoke.kernel_device_ms(
            lambda: A.dkv_reduce(ws, opts["scale"], torch.bfloat16),
            "dkv_reduce_kernel")
        nbytes = ws.numel() * 4 + 2 * b * hkv * t * d * 2
        print(f"dkv_reduce at {auto} slices: device ms {reduce_ms:.4f}, "
              f"{nbytes:,} bytes, bound ms "
              f"{nbytes / chip_smoke.PEAK_BYTES * 1e3:.4f}", flush=True)
    for (name, splits), kernels in times.items():
        label = name if splits is None else f"{name} {splits} sl."
        for kernel, ts in kernels.items():
            print(f"{label:16s} {kernel:3s} mean ms {sum(ts) / len(ts):.4f} "
                  f"over {len(ts)} ({' '.join(f'{x:.4f}' for x in ts)})")
    return 0


TREE_CASES = ("main", "gemma_2b")


def main_trees(trees) -> int:
    """chip_smoke.kernel_case for TREE_CASES in each tree, in turns, one
    process per tree per round (each imports its own tree's package and
    builds its own library)."""
    code = ("import chip_smoke as c\n"
            "for x in c.CASES:\n"
            f"    if x.name in {TREE_CASES!r}: c.kernel_case(x, True)\n")
    for r in range(ROUNDS):
        for tree in trees if r % 2 == 0 else trees[::-1]:
            print(f"round {r} tree {tree}:", flush=True)
            proc = subprocess.run([sys.executable, "-c", code], cwd=tree,
                                  capture_output=True, text=True, check=False)
            for line in proc.stdout.splitlines():
                if "kernel_ms" in line or "dq + dk/dv" in line:
                    print(f"  {tree}: {line.strip()}", flush=True)
            if proc.returncode != 0:
                print(proc.stdout[-4000:] + proc.stderr[-4000:], flush=True)
                return proc.returncode
    return 0


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--d256", action="store_true",
                        help="dq and dk/dv at head-dim class 256")
    parser.add_argument("--trees", nargs="+", default=None,
                        help="checkouts to run chip_smoke's cases in, in "
                             "turns")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is available", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    if args.trees:
        return main_trees(args.trees)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.d256:
        return main_d256()
    from tf_operator_tpu_torch.ops import attention as A

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
                bind(libs[name])
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
