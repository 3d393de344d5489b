"""ctypes binding + binary-protocol client for the native (C++) PS shard.

The port's own binding of `native/ps_server.cpp` (a C++ source outside both
packages, whose wire protocol its header documents; the source is read,
never edited).  The library is built with g++ at first use into
`ops/_build/` (`train/native_build.py`).  `NativeParameterServer` hosts a
shard on C++ threads (no pickle, no GIL on the serve path);
`NativePSClient` is API-compatible with `train/ps.PSClient` (pull/push/
shutdown_servers/close) and speaks the length-prefixed binary tensor
protocol.  Either end interoperates with the JAX package's binding of the
same source.
"""
from __future__ import annotations

import ctypes
import socket
import struct
import threading
from typing import Dict, Optional

import numpy as np

from . import native_build
from .ps import BasePSClient

SOURCE = native_build.NATIVE_DIR / "ps_server.cpp"
_STEM = "tpujob_ps"

_OP_PULL = 1
_OP_PUSH = 2
_OP_SHUTDOWN = 3

_FRAME = struct.Struct("<BQ")  # op, payload length
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None  # guarded-by: _lock
_build_failed = False  # guarded-by: _lock


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        lib = native_build.load(SOURCE, _STEM)
        if lib is None:
            _build_failed = True
            return None
        lib.tpujob_ps_create.restype = ctypes.c_void_p
        lib.tpujob_ps_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_float]
        lib.tpujob_ps_add_param.restype = ctypes.c_int
        lib.tpujob_ps_add_param.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64,
        ]
        lib.tpujob_ps_get_param.restype = ctypes.c_int
        lib.tpujob_ps_get_param.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64,
        ]
        lib.tpujob_ps_start.restype = ctypes.c_int
        lib.tpujob_ps_start.argtypes = [ctypes.c_void_p]
        lib.tpujob_ps_port.restype = ctypes.c_int
        lib.tpujob_ps_port.argtypes = [ctypes.c_void_p]
        lib.tpujob_ps_version.restype = ctypes.c_uint64
        lib.tpujob_ps_version.argtypes = [ctypes.c_void_p]
        lib.tpujob_ps_wait.argtypes = [ctypes.c_void_p]
        lib.tpujob_ps_stop.argtypes = [ctypes.c_void_p]
        lib.tpujob_ps_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_ps_available() -> bool:
    return _load() is not None


class NativeParameterServer:
    """One C++-hosted PS shard (same role as ps.ParameterServer)."""

    def __init__(self, address, params: Dict[str, np.ndarray],
                 lr: float = 0.1) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError("native PS library unavailable (g++ build failed)")
        self._lib = lib
        host, port = address
        self._handle = lib.tpujob_ps_create(
            (host or "0.0.0.0").encode(), int(port), float(lr)
        )
        self._shapes: Dict[str, tuple] = {}
        for name, value in params.items():
            arr = np.ascontiguousarray(value, np.float32)
            self._shapes[name] = arr.shape
            lib.tpujob_ps_add_param(
                self._handle, name.encode(),
                arr.ctypes.data_as(ctypes.c_void_p), arr.size,
            )
        if lib.tpujob_ps_start(self._handle) != 0:
            lib.tpujob_ps_destroy(self._handle)
            raise OSError(f"native PS failed to bind {host}:{port}")

    @property
    def port(self) -> int:
        return self._lib.tpujob_ps_port(self._handle)

    @property
    def version(self) -> int:
        return int(self._lib.tpujob_ps_version(self._handle))

    def get_param(self, name: str) -> np.ndarray:
        shape = self._shapes[name]
        out = np.empty(shape, np.float32)
        rc = self._lib.tpujob_ps_get_param(
            self._handle, name.encode(),
            out.ctypes.data_as(ctypes.c_void_p), out.size,
        )
        if rc != 0:
            raise KeyError(name)
        return out

    def serve_until_shutdown(self) -> None:
        self._lib.tpujob_ps_wait(self._handle)
        self._lib.tpujob_ps_stop(self._handle)

    def stop(self) -> None:
        self._lib.tpujob_ps_stop(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.tpujob_ps_stop(self._handle)
            self._lib.tpujob_ps_destroy(self._handle)
            self._handle = None


def _pack_tensors(tensors: Dict[str, np.ndarray]) -> bytes:
    parts = [_U32.pack(len(tensors))]
    for name, value in tensors.items():
        arr = np.ascontiguousarray(value, np.float32)
        encoded = name.encode()
        parts.append(_U16.pack(len(encoded)))
        parts.append(encoded)
        parts.append(_U64.pack(arr.size))
        parts.append(arr.tobytes())
    return b"".join(parts)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _read_tensors(sock: socket.socket) -> Dict[str, np.ndarray]:
    (count,) = _U32.unpack(_recv_exact(sock, 4))
    out: Dict[str, np.ndarray] = {}
    for _ in range(count):
        (nlen,) = _U16.unpack(_recv_exact(sock, 2))
        name = _recv_exact(sock, nlen).decode()
        (elems,) = _U64.unpack(_recv_exact(sock, 8))
        data = _recv_exact(sock, elems * 4)
        out[name] = np.frombuffer(data, np.float32).copy()
    return out


class NativePSClient(BasePSClient):
    """Binary-protocol transport over the shared client shell (routing,
    partial-push fan-out, shutdown live in ps.BasePSClient).

    Note the flat-vector difference from the Python transport: the wire
    carries shapeless float32 buffers, so pulled params come back 1-D and the
    caller reshapes against its local tree (ps.unflatten_params users already
    reshape via the model's init shapes)."""

    def _request(self, i: int, op: int, payload: bytes = b"") -> socket.socket:
        sock = self._sock(i)
        sock.sendall(_FRAME.pack(op, len(payload)) + payload)
        return sock

    def _pull_shard(self, i: int) -> Dict[str, np.ndarray]:
        sock = self._request(i, _OP_PULL)
        _version = _U64.unpack(_recv_exact(sock, 8))[0]
        return _read_tensors(sock)

    def _push_shard(self, i: int, grads: Dict[str, np.ndarray]) -> None:
        sock = self._request(i, _OP_PUSH, _pack_tensors(grads))
        _U64.unpack(_recv_exact(sock, 8))

    def _shutdown_shard(self, i: int) -> None:
        sock = self._request(i, _OP_SHUTDOWN)
        _recv_exact(sock, 8)
