"""Asynchronous parameter-server runtime (host-side, socket transport).

The port's copy of `tf_operator_tpu/train/ps.py`: parameter shards live on
PS processes in host memory; workers pull, compute gradients on their
device, copy them to the host and push asynchronously (Hogwild-style
downpour SGD).  The PS is a host pattern by design, as in the reference:
a PS process keeps and updates its shard in host memory and computes
nothing on the card.

The wire carries the flax names and layouts (`Dense_0/kernel` as
[784, 500]), and the update is the JAX package's numpy arithmetic, so a
worker of either package can use a PS shard of either
(`models/convert.mnist_to_flax` gives a port worker those names).

Protocol: length-prefixed pickled tuples over TCP.
  ("pull",)              -> {name: np.ndarray}  (this shard's params)
  ("push", {name: grad}) -> ("ok", version)     (applies SGD update)
  ("shutdown",)          -> ("ok",)
Param leaves are assigned to PS replicas round-robin by sorted name.
"""
from __future__ import annotations

import pickle
import socket
import socketserver
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

_LEN = struct.Struct("!Q")


def _send(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv(sock: socket.socket):
    header = _recv_exact(sock, _LEN.size)
    (length,) = _LEN.unpack(header)
    return pickle.loads(_recv_exact(sock, length))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def shard_names(all_names: List[str], num_ps: int, ps_index: int) -> List[str]:
    """Round-robin leaf assignment (deterministic on sorted names)."""
    return [n for i, n in enumerate(sorted(all_names)) if i % num_ps == ps_index]


class ParameterServer(socketserver.ThreadingTCPServer):
    """Holds one shard; applies pushed grads with plain SGD (downpour)."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, address: Tuple[str, int], params: Dict[str, np.ndarray],
                 lr: float = 0.1) -> None:
        self.params = {k: np.asarray(v, np.float32).copy() for k, v in params.items()}
        self.lr = lr
        self.version = 0
        self.lock = threading.Lock()
        self._shutdown_requested = threading.Event()
        super().__init__(address, _PSHandler)

    def serve_until_shutdown(self) -> None:
        thread = threading.Thread(target=self.serve_forever,
                                  name="tpujob-ps-serve", daemon=True)
        thread.start()
        self._shutdown_requested.wait()
        self.shutdown()


class _PSHandler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        server: ParameterServer = self.server  # type: ignore[assignment]
        try:
            while True:
                msg = _recv(self.request)
                op = msg[0]
                if op == "pull":
                    with server.lock:
                        _send(self.request, (dict(server.params), server.version))
                elif op == "push":
                    grads = msg[1]
                    with server.lock:
                        for name, grad in grads.items():
                            if name in server.params:
                                server.params[name] -= server.lr * np.asarray(grad)
                        server.version += 1
                        _send(self.request, ("ok", server.version))
                elif op == "shutdown":
                    _send(self.request, ("ok",))
                    server._shutdown_requested.set()
                    return
                else:
                    _send(self.request, ("err", f"unknown op {op!r}"))
        except (ConnectionError, EOFError):
            return


class BasePSClient:
    """Worker-side view over all PS shards — the transport-agnostic shell
    (socket pool, pull-learned routing, partial-push fan-out, shutdown).
    Subclasses supply the wire protocol via the three _shard hooks; the
    pickle transport below and the binary one (train/native_ps.py) share
    everything else."""

    def __init__(self, addresses: List[str], timeout: float = 30.0) -> None:
        self.addresses = addresses
        self._socks: List[Optional[socket.socket]] = [None] * len(addresses)
        self.timeout = timeout
        # name -> shard index, learned from pull(); authoritative routing.
        self._routes: Dict[str, int] = {}

    # -- transport hooks --

    def _pull_shard(self, i: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def _push_shard(self, i: int, grads: Dict[str, np.ndarray]) -> None:
        raise NotImplementedError

    def _shutdown_shard(self, i: int) -> None:
        raise NotImplementedError

    # -- shared behavior --

    def _sock(self, i: int) -> socket.socket:
        if self._socks[i] is None:
            host, _, port = self.addresses[i].rpartition(":")
            sock = socket.create_connection((host, int(port)), timeout=self.timeout)
            self._socks[i] = sock
        return self._socks[i]

    def pull(self) -> Dict[str, np.ndarray]:
        merged: Dict[str, np.ndarray] = {}
        for i in range(len(self.addresses)):
            shard = self._pull_shard(i)
            for name in shard:
                self._routes[name] = i
            merged.update(shard)
        return merged

    def push(self, grads: Dict[str, np.ndarray]) -> None:
        # Route by the servers' actual shard assignment (learned on pull).
        # Re-deriving routes from sorted(grads) would mis-shard any partial
        # push (e.g. frozen layers excluded) and the server would silently
        # drop the misrouted grads.
        if not self._routes:
            self.pull()
        unknown = [n for n in grads if n not in self._routes]
        if unknown:
            raise KeyError(f"params not hosted by any PS shard: {unknown}")
        by_shard: Dict[int, Dict[str, np.ndarray]] = {}
        for name, grad in grads.items():
            by_shard.setdefault(self._routes[name], {})[name] = grad
        for i, mine in by_shard.items():
            self._push_shard(i, mine)

    def shutdown_servers(self) -> None:
        for i in range(len(self.addresses)):
            try:
                self._shutdown_shard(i)
            except (OSError, ConnectionError):
                pass

    def close(self) -> None:
        for sock in self._socks:
            if sock is not None:
                sock.close()
        self._socks = [None] * len(self.addresses)


class PSClient(BasePSClient):
    """Pickle-protocol transport (matches ParameterServer above)."""

    def _pull_shard(self, i: int) -> Dict[str, np.ndarray]:
        _send(self._sock(i), ("pull",))
        shard, _version = _recv(self._sock(i))
        return shard

    def _push_shard(self, i: int, grads: Dict[str, np.ndarray]) -> None:
        _send(self._sock(i), ("push", grads))
        _recv(self._sock(i))

    def _shutdown_shard(self, i: int) -> None:
        _send(self._sock(i), ("shutdown",))
        _recv(self._sock(i))


def flatten_params(params, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for key, value in params.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            out.update(flatten_params(value, path))
        else:
            out[path] = np.asarray(value, np.float32)
    return out


def unflatten_params(flat: Dict[str, np.ndarray]):
    tree: Dict = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def serve_shard(flat_init: Dict[str, np.ndarray], ps_addresses: List[str],
                task_id: int, lr: float, native: bool = False):
    """Stand up THIS replica's parameter-server shard and block until a
    client sends shutdown.  Shared by every PS-strategy workload (dist_mnist,
    estimator) so transport selection and shard/port wiring cannot drift
    between them.  Returns 0 (exit code)."""
    my_names = shard_names(sorted(flat_init), len(ps_addresses), task_id)
    shard = {n: flat_init[n] for n in my_names}
    _, _, port = ps_addresses[task_id].rpartition(":")
    if native:
        from . import native_ps

        server = native_ps.NativeParameterServer(
            ("0.0.0.0", int(port)), shard, lr=lr)
    else:
        server = ParameterServer(("0.0.0.0", int(port)), shard, lr=lr)
    print(f"ps {task_id} ({'native' if native else 'python'}) serving "
          f"{len(shard)} leaves on :{port}", flush=True)
    server.serve_until_shutdown()
    print("ps shutdown", flush=True)
    return 0


def connect_with_retry(ps_addresses: List[str], native: bool = False,
                       attempts: int = 60, delay: float = 1.0):
    """Client to all PS shards, retrying the first pull until the servers
    come up (PS pods may start after workers).  Returns (client, first_flat)
    or raises ConnectionError after `attempts`."""
    for _ in range(attempts):
        if native:
            from . import native_ps

            client = native_ps.NativePSClient(ps_addresses)
        else:
            client = PSClient(ps_addresses)
        try:
            return client, client.pull()
        except (OSError, ConnectionError):
            client.close()
            time.sleep(delay)
    raise ConnectionError(
        f"could not reach parameter servers {ps_addresses} "
        f"after {attempts} attempts")
