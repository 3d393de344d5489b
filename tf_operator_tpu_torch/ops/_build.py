"""Build and load the port's CUDA kernels.

`ops/csrc/flash_attention.cu` (with the headers beside it) is compiled by
`nvcc` for Hopper (`sm_90a`) into a shared library with a plain C interface
and loaded with `ctypes`: no PyTorch headers are compiled, so a build takes
seconds.  The library is built at first use, from the sources in this
checkout only, into `ops/_build/` (git-ignored), under a name keyed by a
hash of the flags and of every file under `ops/csrc/`, so an edited kernel
or header is rebuilt and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# nvcc's output (the ptxas register/spill report) when this process built
# the library; None when it was already built
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


def target() -> Path:
    """The library's path for the sources now under CSRC: the hash covers
    the flags and every file's name and bytes."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        digest.update(str(path.relative_to(CSRC)).encode() + b"\0")
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{SOURCE.stem}-{digest.hexdigest()[:16]}.so"


def nvcc(source: Path, out: Path) -> str:
    """Compile `source` into the shared library `out` and return nvcc's
    output; raises with that output when the build fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
    proc = subprocess.run([_nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           str(source)], capture_output=True, text=True,
                          check=False)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source.name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def library() -> ctypes.CDLL:
    """The kernels' library, built first if this source has no build yet."""
    global build_log
    out = target()
    if not out.exists():
        build_log = nvcc(SOURCE, out)
    return ctypes.CDLL(str(out))
