"""Weight distribution over the network (learner -> remote actors), v1.

Counterpart of ``WeightServer`` and ``WeightClient`` in
``d4pg_tpu/distributed/weight_server.py``: request/response over TCP in
the reference's frames (``core/wire.py``'s weights-v1 rows):

  client sends   [u32 magic][i64 have_version]
  server replies [u32 magic][u32 len][payload]   (len == 0: not newer)

payload = ``np.savez`` of ``__version__``, ``__step__``, the actor's
parameters and, when observation normalization is on,
``__norm_mean__``, ``__norm_std__`` and ``__norm_clip__`` (a float64
scalar): the statistics remote actors standardize their policy input
with.

The parameters cross the wire in the reference's tree layout, so a JAX
learner feeds torch actors and a torch learner feeds JAX actors:
``_flatten`` turns the store's torch ``state_dict`` into the Flax tree
(``io/from_jax.flax_layout``: Dense kernels [in, out], LayerNorm
``scale``, the keys of each level sorted as JAX's dict pytrees hold them)
and joins its keys with ``'/'``, the grammar of the reference's
``parallel/partition.named_flat`` (``params/fc1/kernel``); ``_unflatten``
splits them back into the tree, and ``WeightClient`` hands its actor the
torch ``state_dict`` of that tree (``io/from_jax.torch_layout``).

The server memoizes the serialized frame by version under the declared
``wserve`` tier lock, held across the fill (single flight: N pullers of
one version cost one flatten and one savez); the fill reads the store's
``snapshot_ex`` (``wstore``, below ``wserve``). ``weight_plane.
WeightPlaneServer`` subclasses this server and answers v1 and the v2
plane (deltas, quantized codecs, fencing) on one port, as the
reference's does.
"""

from __future__ import annotations

import io
import socket
import threading
import time
import zipfile

import numpy as np
import torch

from d4pg_tpu_torch.core.locking import TieredLock
from d4pg_tpu_torch.core.wire import (
    MAGIC_WEIGHTS_V1 as _MAGIC,
    WEIGHTS_V1_REQ as _REQ,
    WEIGHTS_V1_RESP as _RESP,
)
from d4pg_tpu_torch.distributed.transport import (
    MAX_PAYLOAD,
    ConnRegistry,
    ProtocolError,
    ReconnectingClient,
    _recv_exact,
    server_handshake,
)
from d4pg_tpu_torch.io.from_jax import flax_layout, torch_layout
from d4pg_tpu_torch.obs.containment import contained_crash
from d4pg_tpu_torch.obs.flight import record_event


def _flatten(params: dict) -> dict[str, np.ndarray]:
    """A torch ``state_dict`` as its Flax tree's ``{'params/fc1/kernel':
    array, ...}``, in the tree's key order."""
    flat: dict[str, np.ndarray] = {}

    def walk(prefix: str, node) -> None:
        for key, value in node.items():
            name = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(value, dict):
                walk(name, value)
            else:
                flat[name] = np.asarray(value)

    walk("", flax_layout(params))
    return flat


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    """Invert ``_flatten``: the nested Flax tree."""
    tree: dict = {}
    for name, value in flat.items():
        *path, leaf = name.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


class WeightServer(ConnRegistry):
    """Serves a ``WeightStore``'s latest parameters to remote pullers.
    Binds loopback by default; a shared ``secret`` gates pullers with the
    transport's HMAC handshake."""

    def __init__(self, store, host: str = "127.0.0.1", port: int = 0,
                 secret: str | None = None):
        super().__init__()
        self._store = store
        self._secret = secret
        self._frame_lock = TieredLock("wserve")
        self._frame_memo: tuple[int, bytes] | None = None
        self.frame_encodes = 0  # fills (memo misses)
        self.pulls_served = 0  # frames answered with weights
        # the last version served to each peer ("host:port"), written by
        # its connection thread only
        self.served_versions: dict[str, int] = {}
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, port))
        self._server.listen()
        self.port = self._server.getsockname()[1]
        self._stop = threading.Event()
        self._conn_threads: list[threading.Thread] = []
        self._thread = threading.Thread(target=self._accept, daemon=True)
        self._thread.start()

    def _accept(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    self._server.settimeout(0.2)
                    conn, _ = self._server.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return
                self._register_conn(conn)
                self._conn_threads = [t for t in self._conn_threads
                                      if t.is_alive()]
                t = threading.Thread(target=self._serve, args=(conn,),
                                     daemon=True)
                self._conn_threads.append(t)
                t.start()
        except Exception as e:
            contained_crash("weights.accept", e)

    def _legacy_frame(self, have: int) -> bytes | None:
        """The memoized v1 body for a puller at version ``have``: None
        when nothing newer exists."""
        got = self._versioned_frame(have)
        return None if got is None else got[1]

    def _versioned_frame(self, have: int) -> tuple[int, bytes] | None:
        """``(version, body)`` of the newest frame, or None when the
        puller at ``have`` is up to date; filled once per version."""
        with self._frame_lock:
            snap = self._store.snapshot_ex()
            version, params = snap["version"], snap["params"]
            if params is None or version <= have:
                return None
            if self._frame_memo is not None and self._frame_memo[0] == version:
                return self._frame_memo
            flat = _flatten(params)
            norm = snap["norm_stats"]
            if norm is not None:
                flat["__norm_mean__"] = np.asarray(norm[0])
                flat["__norm_std__"] = np.asarray(norm[1])
                if len(norm) > 2:  # the clip radius travels with the stats
                    flat["__norm_clip__"] = np.float64(norm[2])
            buf = io.BytesIO()
            np.savez(buf, __version__=np.int64(version),
                     __step__=np.int64(snap["step"]), **flat)
            self._frame_memo = (version, buf.getvalue())
            self.frame_encodes += 1
            return self._frame_memo

    def _serve(self, conn: socket.socket) -> None:
        try:
            self._serve_conn(conn)
        except Exception as e:
            contained_crash("weights.serve", e)

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            peer = "%s:%d" % conn.getpeername()[:2]
            with conn:
                if not server_handshake(conn, self._secret):
                    return
                while not self._stop.is_set():
                    req = _recv_exact(conn, _REQ.size)
                    if req is None:
                        return
                    magic, have = _REQ.unpack(req)
                    if magic != _MAGIC:
                        return
                    self._answer_v1(conn, peer, have)
        except OSError:
            return  # the peer died mid-frame (actor terminated)
        finally:
            self._unregister_conn(conn)

    def _answer_v1(self, conn: socket.socket, peer: str, have: int) -> None:
        """Send the v1 response to a puller at version ``have``."""
        got = self._versioned_frame(have)
        if got is None:
            conn.sendall(_RESP.pack(_MAGIC, 0))
            return
        version, payload = got
        # counted before the send: the puller may act on the frame before
        # this thread runs again
        self.pulls_served += 1
        self.served_versions[peer] = version
        conn.sendall(_RESP.pack(_MAGIC, len(payload)) + payload)

    def close(self) -> None:
        self._stop.set()
        try:
            self._server.close()
        except OSError:
            pass
        # the accept loop wakes within its 0.2 s poll and lets the
        # listening socket go; a peer it accepted meanwhile is shut below
        self._thread.join(timeout=1.0)
        self._shutdown_conns()
        for t in self._conn_threads:
            t.join(timeout=2.0)
        self._conn_threads.clear()


class WeightClient(ReconnectingClient):
    """Actor-side puller with the ``WeightStore`` reader interface
    (``get_if_newer``), so a remote actor's policy client reads the wire
    as it reads a store. ``get_if_newer`` returns ``(version,
    state_dict)``, the torch names of the frame's Flax tree; ``step`` and
    ``norm_stats`` (``(mean, std, clip)`` when served) describe the last
    frame adopted.

    As in the reference, it degrades to stale weights while the learner
    is down: a failed pull drops the socket and returns None ("nothing
    newer"); later pulls reconnect at most once per
    ``reconnect_interval``; past ``down_timeout`` seconds of continuous
    failure it raises. Wire-format faults (``ProtocolError``) raise at
    once, and so does a failure before the first successful pull (a
    wrong secret closes the connection)."""

    def __init__(self, host: str, port: int, connect_timeout: float = 10.0,
                 secret: str | None = None, down_timeout: float = 300.0,
                 reconnect_interval: float = 10.0):
        self._down_timeout = down_timeout
        self._down_since: float | None = None
        self._ever_pulled = False
        self._reconnect_interval = reconnect_interval
        self._next_reconnect = 0.0
        super().__init__(host, port, connect_timeout, secret)
        self.step = 0
        self.norm_stats: tuple | None = None

    def get_if_newer(self, have_version: int):
        with self._lock:
            self._check_open()
            if (self._sock is None and self._ever_pulled
                    and time.monotonic() < self._next_reconnect):
                return None  # between rate-limited reconnect attempts
            try:
                if self._sock is None:
                    self._next_reconnect = (time.monotonic()
                                            + self._reconnect_interval)
                    self._connect()
                payload = self._pull(have_version)
                self._ever_pulled = True
                if self._down_since is not None:
                    record_event("weight_stale_exit",
                                 addr=f"{self._addr[0]}:{self._addr[1]}",
                                 down_s=round(
                                     time.monotonic() - self._down_since, 3))
                self._down_since = None
            except ProtocolError:
                self._drop_sock()
                raise
            except (OSError, ConnectionError):
                self._drop_sock()
                self._check_open()
                if not self._ever_pulled:
                    raise
                now = time.monotonic()
                if self._down_since is None:
                    self._down_since = now
                    record_event("weight_stale_enter",
                                 addr=f"{self._addr[0]}:{self._addr[1]}",
                                 have_version=int(have_version))
                if now - self._down_since > self._down_timeout:
                    raise ConnectionError(
                        f"weight server unreachable for "
                        f"{self._down_timeout:.0f}s at "
                        f"{self._addr[0]}:{self._addr[1]}")
                return None  # act on stale weights; retry next pull
        if payload is None:
            return None
        try:
            with np.load(io.BytesIO(payload)) as z:
                flat = {k: z[k] for k in z.files if not k.startswith("__")}
                version = int(z["__version__"])
                step = int(z["__step__"])
                norm: tuple | None = None
                if "__norm_mean__" in z.files:
                    norm = (z["__norm_mean__"], z["__norm_std__"])
                    if "__norm_clip__" in z.files:
                        norm += (float(z["__norm_clip__"]),)
        except (ValueError, KeyError, OSError, zipfile.BadZipFile) as e:
            with self._lock:
                self._drop_sock()
            raise ProtocolError(f"corrupt weight payload: {e}") from e
        # commit only after the whole body parsed
        self.step = step
        if norm is not None:
            self.norm_stats = norm
        tree = _unflatten(flat)
        params = {name: torch.from_numpy(np.array(a))
                  for name, a in torch_layout(tree["params"]).items()}
        return version, params

    def _pull(self, have_version: int) -> bytes | None:
        """One request/response on the live socket; raises on any break."""
        self._sock.sendall(_REQ.pack(_MAGIC, int(have_version)))
        head = _recv_exact(self._sock, _RESP.size)
        if head is None:
            raise ConnectionError("weight server closed the connection")
        magic, length = _RESP.unpack(head)
        if magic != _MAGIC or length > MAX_PAYLOAD:
            raise ProtocolError("corrupt weight stream")
        if length == 0:
            return None
        payload = _recv_exact(self._sock, length)
        if payload is None:
            raise ConnectionError("truncated weight payload")
        return payload
