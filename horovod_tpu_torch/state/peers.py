"""Peer-replicated snapshot mirror: each rank pushes its latest shard
snapshot to its ring neighbour (``rank+1 mod size``) over a socket of
the state plane's own.

Own copy of ``horovod_tpu/state/peers.py``, with no torch in it (the
frames are pickles; a tensor in one unpickles through torch's own
reducers).  The Gemini shape (PAPERS.md): the redundancy lives in a
peer's host memory, so losing a rank costs one O(model/size) transfer
from the survivor holding its copy instead of an O(model) root
broadcast.  The push runs on the snapshot worker, out of step with the
training loop, so it cannot ride the engine's negotiated collectives
(nor its point-to-point plane, whose sends pair with a receive in
program order): one listener per rank, one connect-push-close per
snapshot.  Endpoints are exchanged through a named allgather when the
plane wires its peers and again after every reshape.

Torn pushes cannot poison the store: a frame is length-prefixed and the
receiver installs it only after every byte arrived and unpickled — a rank
crashing mid-push (exactly the case this plane exists for) leaves the
neighbor's previous copy intact.  Scope matches elastic membership:
single-host jobs (the launcher rejects ``--hosts`` + elastic), so the
listener binds ``HVD_TPU_STATE_BIND`` (default 127.0.0.1).

TRUST BOUNDARY: frames are pickled and the listener is unauthenticated
— the same trust model as the engine's own cleartext TCP control/data
planes, which accept raw frames from anyone who can connect.  Unpickling
attacker bytes is code execution, so ``HVD_TPU_STATE_BIND`` must never
expose the port beyond the loopback/cluster network the engine already
trusts (docs/fault-tolerance.md#state-plane).
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
from typing import Optional

from horovod_tpu_torch.common import metrics as _metrics

_MAGIC = b"HVDSTAT1"
# magic + (src_rank, src_size, step, sig, nbytes) little-endian int64s;
# sig is the sender's state-shape signature (plane._state_signature) —
# restore only trusts a copy cut under the receiver's current shape.
_HEADER = struct.Struct("<8sqqqqq")
# A shard frame is bounded by the model size; 16 GiB is far past any
# single-rank shard this plane will ever carry and keeps a corrupt
# header from triggering a giant allocation.
_MAX_FRAME = 16 << 30


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            return None  # torn push: sender died mid-frame
        buf.extend(chunk)
    return bytes(buf)


class PeerMirror:
    """Listener + latest-copy store for one rank's incoming peer shard."""

    def __init__(self, bind_host: Optional[str] = None):
        self._host = (bind_host
                      or os.environ.get("HVD_TPU_STATE_BIND")
                      or "127.0.0.1")
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((self._host, 0))
        self._server.listen(4)
        self._lock = threading.Lock()
        self._latest: Optional[dict] = None
        self._closed = False
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True,
                                        name="hvd-torch-state-peer")
        self._thread.start()

    @property
    def endpoint(self) -> str:
        return f"{self._host}:{self._server.getsockname()[1]}"

    # -- receive ----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return  # listener closed
            try:
                self._receive(conn)
            except Exception:
                pass  # a malformed push must never kill the listener
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def _receive(self, conn: socket.socket) -> None:
        conn.settimeout(30.0)
        raw = _recv_exact(conn, _HEADER.size)
        if raw is None:
            return
        magic, src_rank, src_size, step, sig, nbytes = _HEADER.unpack(raw)
        if magic != _MAGIC or not 0 <= nbytes <= _MAX_FRAME:
            return
        payload = _recv_exact(conn, nbytes)
        if payload is None:
            return  # torn mid-payload: keep the previous intact copy
        leaves = pickle.loads(payload)
        with self._lock:
            self._latest = {"src": int(src_rank), "size": int(src_size),
                            "step": int(step), "sig": int(sig),
                            "leaves": leaves}
        _metrics.registry.record_state_peer(received_step=int(step))

    # -- send -------------------------------------------------------------

    @staticmethod
    def push(endpoint: str, src_rank: int, src_size: int, step: int,
             leaves: dict, sig: int = 0, timeout: float = 30.0) -> bool:
        """Push one shard snapshot to a neighbor's mirror; False (never a
        raise) when the neighbor is unreachable — a dead peer is the
        normal case this plane tolerates."""
        host, _, port = endpoint.rpartition(":")
        try:
            payload = pickle.dumps(leaves, protocol=pickle.HIGHEST_PROTOCOL)
            with socket.create_connection((host, int(port)),
                                          timeout=timeout) as conn:
                conn.sendall(_HEADER.pack(_MAGIC, src_rank, src_size, step,
                                          sig, len(payload)))
                conn.sendall(payload)
            _metrics.registry.record_state_peer(sent_bytes=len(payload))
            return True
        except (OSError, ValueError):
            return False

    # -- reading ----------------------------------------------------------

    def latest(self) -> Optional[dict]:
        """The newest fully-received peer copy:
        ``{"src", "size", "step", "leaves"}`` or None."""
        with self._lock:
            return self._latest

    def clear(self) -> None:
        """Drop the held copy (its partition died with the old
        membership)."""
        with self._lock:
            self._latest = None

    def close(self) -> None:
        self._closed = True
        try:
            self._server.close()
        except OSError:
            pass
