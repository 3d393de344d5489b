"""ctypes binding for the native (C++) prefetching image loader.

The port's own binding of `native/dataloader.cpp` (a C++ source outside
both packages; `tf_operator_tpu/train/native_data.py` is the JAX package's
binding).  The library is built at first use with g++ into `ops/_build/`
(`train/native_build.py`).  The loader generates class-conditional images
on C++ threads into a bounded queue; its values follow `train/data.synthetic_images`' recipe but are not
the same stream (uniform noise, its own generator).

`images_or_fallback` keeps the reference's contract: the native loader
where it builds, else the Python generator; it prints one line naming the
source it took.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

from . import native_build

SOURCE = native_build.NATIVE_DIR / "dataloader.cpp"
_STEM = "tpujob_data"

_KIND_IMAGES = 0
# the reference binding's settings for images
_PREFETCH_DEPTH = 4
_THREADS = 4

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None  # guarded-by: _lock
_build_failed = False  # guarded-by: _lock


def target() -> Path:
    """The library's path for the source now in the checkout."""
    return native_build.target(SOURCE, _STEM)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        lib = native_build.load(SOURCE, _STEM)
        if lib is None:
            _build_failed = True
            return None
        lib.dl_create.restype = ctypes.c_void_p
        lib.dl_create.argtypes = [ctypes.c_int] * 5 + [
            ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
        ]
        lib.dl_next.restype = ctypes.c_int
        lib.dl_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p]
        lib.dl_x_size.restype = ctypes.c_int64
        lib.dl_x_size.argtypes = [ctypes.c_void_p]
        lib.dl_destroy.restype = None
        lib.dl_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class NativeImages:
    """Batches {"x": [B, H, W, 3] f32, "label": [B] int32} from the native
    loader's queue; `close()` stops its threads."""

    def __init__(self, batch_size: int, image_size: int, num_classes: int,
                 seed: int) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError("native dataloader unavailable")
        self._lib = lib
        self._handle = lib.dl_create(
            _KIND_IMAGES, batch_size, image_size, 0, num_classes,
            seed & 0xFFFFFFFF, _PREFETCH_DEPTH, _THREADS)
        self._shape = (batch_size, image_size, image_size, 3)
        self._x = np.empty(int(lib.dl_x_size(self._handle)), np.float32)
        self._y = np.empty(batch_size, np.int32)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._handle is None:
            raise StopIteration  # closed: a NULL handle would crash in C++
        rc = self._lib.dl_next(self._handle,
                               self._x.ctypes.data_as(ctypes.c_void_p),
                               self._y.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise StopIteration
        return {"x": self._x.reshape(self._shape).copy(),
                "label": self._y.copy()}

    def close(self) -> None:
        if self._handle:
            self._lib.dl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def images_or_fallback(batch_size: int, image_size: int = 224,
                       num_classes: int = 1000, seed: int = 0) -> Iterator:
    """The native loader when it builds, else `train/data.synthetic_images`;
    prints which."""
    if native_available():
        print(f"image source: native ({SOURCE.name}, {target().name})",
              flush=True)
        return NativeImages(batch_size, image_size, num_classes, seed)
    from .data import synthetic_images

    print("image source: python (train/data.synthetic_images)", flush=True)
    return synthetic_images(batch_size, image_size, num_classes, seed)
