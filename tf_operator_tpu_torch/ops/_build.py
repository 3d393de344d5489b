"""Build and load the port's CUDA kernels.

`ops/csrc/flash_attention.cu` (with the headers beside it) is compiled by
`nvcc` for Hopper (`sm_90a`) into a shared library with a plain C interface
and loaded with `ctypes`: no PyTorch headers are compiled.  The source is
split into translation units (`FA_PART` 1..PARTS: the forward in bf16 and
in fp16, each of its two routes apart, dq and dk/dv in each, the f32
kernels, the C interface, and apart from these the head-dim class 256: its
forward in bf16 and in fp16, its dq, its dk/dv, its f32 kernels; and the
sliced kernels of every head dim above 256: their forward in bf16 and in
fp16, their dq, their dk/dv, their f32 kernels; and the cluster kernels
of dq and dk/dv up to head dim 1024, each in bf16 and in fp16), compiled
by one `nvcc` each, all started together, and linked into one library, so
a build takes about as long as its largest part.  The library is built at
first use, from the sources in this checkout only, into `ops/_build/`
(git-ignored), under a name keyed by a hash of the flags, the parts and
every file under `ops/csrc/`, so an edited kernel or header is rebuilt and
a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# (warning 177, "declared but never referenced", is each part's view of
# what the other parts instantiate)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v", "-diag-suppress", "177")
# the translation units of flash_attention.cu (its FA_PART values)
PARTS = 24

# nvcc's output (the ptxas register/spill report of every part) when this
# process built the library; None when it was already built
build_log: Optional[str] = None


def _nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels are "
        "built from ops/csrc at first use on a machine with the CUDA toolkit")


def source_digest() -> "hashlib._Hash":
    """sha256 over the flags, the parts and every file's name and bytes
    under CSRC (the library's key; `ops/autotune.py` keys its cache on it
    too)."""
    digest = hashlib.sha256(f"{' '.join(NVCC_FLAGS)} parts {PARTS}".encode())
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        digest.update(str(path.relative_to(CSRC)).encode() + b"\0")
        digest.update(path.read_bytes())
    return digest


def target() -> Path:
    """The library's path for the sources now under CSRC."""
    return BUILD_DIR / f"lib{SOURCE.stem}-{source_digest().hexdigest()[:16]}.so"


def nvcc(source: Path, out: Path) -> str:
    """Compile the PARTS translation units of `source` in parallel, link
    them into the shared library `out`, and return nvcc's output; raises
    with that output when a step fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc_bin = _nvcc_path()
    with tempfile.TemporaryDirectory(prefix=f"{out.stem}.",
                                     dir=out.parent) as tmp:
        objs = [Path(tmp) / f"part{n}.o" for n in range(1, PARTS + 1)]
        procs = [subprocess.Popen(
            [nvcc_bin, *NVCC_FLAGS, f"-DFA_PART={n}", "-c", "-o", str(obj),
             str(source)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for n, obj in enumerate(objs, 1)]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [f"part {n} (exit {proc.returncode}):\n{log}"
                  for n, (proc, log) in enumerate(zip(procs, logs), 1)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed for {source.name} "
                               + "\n".join(failed))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run([nvcc_bin, "-shared", "-o", str(tmp_lib),
                               *map(str, objs)], capture_output=True,
                              text=True, check=False)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            raise RuntimeError(f"linking {out.name} failed (exit "
                               f"{link.returncode}):\n{logs[-1]}")
        os.replace(tmp_lib, out)
    return "".join(logs)


def library() -> ctypes.CDLL:
    """The kernels' library, built first if this source has no build yet."""
    global build_log
    out = target()
    if not out.exists():
        build_log = nvcc(SOURCE, out)
    return ctypes.CDLL(str(out))
