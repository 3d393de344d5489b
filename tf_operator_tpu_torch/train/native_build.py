"""Build a single-file C++ source of `native/` with g++ and load it.

The port's libraries of the repo's native sources (`native/dataloader.cpp`
for `train/native_data.py`, `native/ps_server.cpp` for
`train/native_ps.py`) are built at first use into `ops/_build/`
(git-ignored), under a name keyed by a hash of the source and the flags, so
an edited source is rebuilt and a stale library is never loaded.  g++
writes to a per-process temporary name that is renamed over the target, so
processes that start together each see a complete library or none.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "ops" / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


def target(source: Path, stem: str) -> Path:
    """The library's path for `source` as it is now in the checkout."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(source.read_bytes())
    return BUILD_DIR / f"lib{stem}-{digest.hexdigest()[:16]}.so"


def _build(source: Path, out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(source),
                        "-lpthread"], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def load(source: Path, stem: str) -> Optional[ctypes.CDLL]:
    """The library of `source`, built first when this source has none; None
    when g++ or the source is missing or the build fails."""
    if not source.exists():
        return None
    out = target(source, stem)
    if not out.exists() and not _build(source, out):
        return None
    try:
        return ctypes.CDLL(str(out))
    except OSError:
        # a library built elsewhere (another libc): build it here
        if _build(source, out):
            return ctypes.CDLL(str(out))
        return None
