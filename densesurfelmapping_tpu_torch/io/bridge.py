"""Live ingestion bridge: a socket feed speaking the PoseMessage schema.

Counterpart of the JAX package's `io/bridge.py` (numpy and sockets only),
serving the port's drivers (`SurfelMapping`, `DeviceResidentMapping`).  The
wire format is the same byte for byte, so a client of either package can
drive a server of the other.  The server's fuse thread feeds the driver, so
the driver's device work (the kernels included) is enqueued from that
thread, on its current CUDA stream.

The reference is a *live* ROS node — images, depths and pose/loop triples
arrive over topics and land in deep decoupling queues before the fuse loop
consumes them (`ros_node.cpp:24-32`: 5000-deep image/depth subscriptions;
`surfel_map.cpp:83-101` buffer pushes).  This module is the rebuild's
equivalent transport: a length-prefixed binary protocol over TCP (or a
Unix-domain socket) carrying exactly the topic contract of SURVEY.md §1 —
intensity image, metric depth (or a rectified stereo pair), and the per-
frame pose message (Twc, is-keyframe flag, reference-keyframe index,
loop-corrected keyframe path, loop-edge index pairs), plus `save_map`
(`surfel_map.cpp:75-81`) and a metrics probe.

Architecture (mirrors the reference's process split):

    MappingClient (sensor/SLAM process)          MappingServer (fuse process)
      publish_image/depth/stereo/pose  ──TCP──►   reader thread ─► bounded
      save_map / metrics / shutdown               ingest queue ─► fuse thread
                                                  (SurfelMapping.feed_*)

The reader thread only deserializes and enqueues — the fuse loop drains the
queue at its own pace, so a slow fuse step never stalls the socket (the
reference's queue decoupling).  The queue is bounded like `max_buffered`;
when full the OLDEST frame message drops with accounting (ROS queue
semantics).  Pose messages survive preferentially — loop corrections
desync the keyframe database if lost — and only yield (oldest first) once
the backed-up queue contains nothing but poses.

Wire format, little-endian:  header = magic b"DSM1" | u8 type | 3 pad |
u64 payload_len, then the payload.  Array-carrying payloads are a single
``np.savez`` archive (self-describing shapes/dtypes; zero parsing code on
either side); control payloads are UTF-8 JSON.
"""

from __future__ import annotations

import io as _io
import json
import queue
import socket
import struct
import threading
from typing import Dict, Optional, Tuple

import numpy as np

_MAGIC = b"DSM1"
_HEADER = struct.Struct("<4sB3xQ")

# message types
T_IMAGE = 1       # npz: stamp, image (H,W) — feed_image
T_DEPTH = 2       # npz: stamp, depth (H,W) f32, 0 = invalid — feed_depth
T_STEREO = 3      # npz: stamp, left, right (H,W) — feed_stereo
T_POSE = 4        # npz: stamp, pose (4,4), iskf, ref, edges (E,2)
                  #      [+ loop_path (K,4,4) when present] — feed_pose
T_SAVE = 5        # json: {path, what: cloud|mesh|checkpoint|trajectory}
T_METRICS = 6     # json: {} -> T_REPLY with driver.metrics() + bridge stats
T_SHUTDOWN = 7    # json: {} -> T_REPLY ack, then the server loop exits
T_REPLY = 8       # json reply (server -> client)

_MAX_PAYLOAD = 1 << 30


def _send_msg(sock: socket.socket, mtype: int, payload: bytes) -> None:
    sock.sendall(_HEADER.pack(_MAGIC, mtype, len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            return None
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _recv_msg(sock: socket.socket) -> Optional[Tuple[int, bytes]]:
    header = _recv_exact(sock, _HEADER.size)
    if header is None:
        return None
    magic, mtype, length = _HEADER.unpack(header)
    if magic != _MAGIC:
        raise ValueError(f"bad magic {magic!r} on bridge socket")
    if length > _MAX_PAYLOAD:
        raise ValueError(f"oversized bridge payload ({length} bytes)")
    payload = _recv_exact(sock, length) if length else b""
    if payload is None:
        return None
    return mtype, payload


def _pack_arrays(**arrays) -> bytes:
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _unpack_arrays(payload: bytes) -> Dict[str, np.ndarray]:
    z = np.load(_io.BytesIO(payload))
    return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------
class MappingClient:
    """Publisher side of the bridge (the sensor/SLAM process).

    Plays the role of the reference's publisher + ORB-SLAM2 bridge nodes
    (`kitti_publisher/scripts/publisher.py:15-71`, `ros_stereo.cc:200-320`):
    it owns no map state, it just streams the topic contract.
    """

    def __init__(self, address, timeout: float = 30.0):
        self._sock = _connect(address, timeout)
        self._lock = threading.Lock()

    # -- streaming ------------------------------------------------------
    def publish_image(self, stamp: float, image: np.ndarray) -> None:
        self._send(T_IMAGE, _pack_arrays(
            stamp=np.float64(stamp), image=np.asarray(image)))

    def publish_depth(self, stamp: float, depth: np.ndarray) -> None:
        self._send(T_DEPTH, _pack_arrays(
            stamp=np.float64(stamp), depth=np.asarray(depth, np.float32)))

    def publish_stereo(self, stamp: float, left: np.ndarray,
                       right: np.ndarray) -> None:
        self._send(T_STEREO, _pack_arrays(
            stamp=np.float64(stamp), left=np.asarray(left),
            right=np.asarray(right)))

    def publish_pose(self, stamp: float, pose: np.ndarray,
                     loop_path=None, loop_edges=(),
                     is_keyframe: bool = False,
                     reference_index: Optional[int] = None) -> None:
        arrays = dict(
            stamp=np.float64(stamp), pose=np.asarray(pose, np.float64),
            iskf=np.bool_(is_keyframe),
            ref=np.int64(-1 if reference_index is None else reference_index),
            edges=np.asarray(list(loop_edges), np.int64).reshape(-1, 2))
        if loop_path is not None:
            arrays["loop_path"] = np.asarray(loop_path, np.float64)
        self._send(T_POSE, _pack_arrays(**arrays))

    # -- control (synchronous request/reply) ----------------------------
    def save_map(self, path: str, what: str = "mesh") -> dict:
        return self._request(T_SAVE, {"path": path, "what": what})

    def metrics(self, drain: bool = True) -> dict:
        """Driver + bridge counters.  drain=True (default) waits for every
        already-published message to be fused first — the reply then
        reflects the full stream; drain=False samples live without
        blocking the request on fuse progress."""
        return self._request(T_METRICS, {"drain": drain})

    def shutdown(self) -> dict:
        """Ask the server to drain, optionally autosave, and exit."""
        return self._request(T_SHUTDOWN, {})

    def close(self) -> None:
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- internals ------------------------------------------------------
    def _send(self, mtype: int, payload: bytes) -> None:
        with self._lock:
            _send_msg(self._sock, mtype, payload)

    def _request(self, mtype: int, body: dict) -> dict:
        with self._lock:
            _send_msg(self._sock, mtype, json.dumps(body).encode())
            got = _recv_msg(self._sock)
        if got is None:
            raise ConnectionError("bridge server closed during request")
        rtype, payload = got
        if rtype != T_REPLY:
            raise ValueError(f"expected reply, got message type {rtype}")
        reply = json.loads(payload.decode())
        if not reply.get("ok", False):
            raise RuntimeError(f"bridge request failed: {reply.get('error')}")
        return reply


def _connect(address, timeout: float) -> socket.socket:
    if isinstance(address, str) and "/" in address:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        sock.connect(address)
    else:
        host, port = address if isinstance(address, tuple) else \
            address.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)), timeout=timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    # timeout applies to connecting only: control requests legitimately
    # block while the server drains (a first call builds the kernels)
    sock.settimeout(None)
    return sock


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------
class MappingServer:
    """Fuse side of the bridge: owns a SurfelMapping and drains the wire.

    Equivalent of `ros_node.cpp:13-53`: subscribe, decouple through queues,
    fuse in its own loop, save on shutdown.  One client at a time (the
    reference likewise has one producer pipeline); ``serve_forever`` accepts
    sequential reconnects until ``shutdown()`` — a mid-stream reconnect
    resumes into the same live map.
    """

    def __init__(self, driver, address=("127.0.0.1", 0),
                 queue_depth: int = 256, autosave: Optional[str] = None):
        self.driver = driver
        self.autosave = autosave
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        # messages accepted but not yet fused or dropped; tracked separately
        # from the queue because a message popped by the fuse thread is
        # still "pending" until its feed_* returns — _drain must cover it
        self._pending = 0
        self._pending_cv = threading.Condition()
        # the driver is not thread-safe: the fuse thread and control
        # requests (save/metrics run on the reader thread) serialize here
        self._drv_lock = threading.Lock()
        self._stop = threading.Event()
        self.stats = {"received": 0, "frames": 0, "poses": 0,
                      "dropped_frames": 0, "reconnects": 0}
        self._listener = _listen(address)
        self.address = self._listener.getsockname()
        self._fuse_thread = threading.Thread(
            target=self._fuse_loop, name="bridge-fuse", daemon=True)
        self._fuse_thread.start()

    # -- lifecycle ------------------------------------------------------
    def serve_forever(self) -> None:
        """Accept + read until a client requests shutdown."""
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = self._listener.accept()
                except OSError:
                    break  # listener closed by shutdown()
                self.stats["reconnects"] += 1
                try:
                    self._read_loop(conn)
                except ConnectionError:
                    pass  # client reset mid-stream; await a reconnect
                finally:
                    conn.close()
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        self._listener.close()
        if isinstance(self.address, str):
            import os
            try:
                os.unlink(self.address)
            except OSError:
                pass
        self._fuse_thread.join(timeout=60.0)
        if self.autosave:
            with self._drv_lock:
                self.driver.save_mesh(self.autosave)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # -- socket side ----------------------------------------------------
    def _read_loop(self, conn: socket.socket) -> None:
        while not self._stop.is_set():
            got = _recv_msg(conn)
            if got is None:
                return  # client went away; accept a reconnect
            mtype, payload = got
            if mtype in (T_IMAGE, T_DEPTH, T_STEREO, T_POSE):
                self._enqueue(mtype, payload)
                self.stats["received"] += 1
            elif mtype in (T_SAVE, T_METRICS, T_SHUTDOWN):
                reply = self._control(mtype, payload)
                try:
                    _send_msg(conn, T_REPLY, json.dumps(reply).encode())
                except (BrokenPipeError, ConnectionResetError):
                    return  # client vanished mid-request; await a reconnect
                if mtype == T_SHUTDOWN:
                    self._stop.set()
                    self._listener.close()
                    return
            else:
                raise ValueError(f"unknown bridge message type {mtype}")

    def _enqueue(self, mtype: int, payload: bytes) -> None:
        with self._pending_cv:
            self._pending += 1
        while True:
            try:
                self._queue.put_nowait((mtype, payload))
                return
            except queue.Full:
                # ROS queue semantics: drop the oldest FRAME; poses are
                # requeued (loop corrections must not be lost — see module
                # docstring) so scan for the oldest frame entry instead.
                if not self._drop_oldest_frame():
                    if mtype != T_POSE:
                        # queue is all poses and the incoming message is a
                        # frame: drop the incoming frame instead
                        self.stats["dropped_frames"] += 1
                        self._dec_pending()
                        return
                    # all-pose queue + incoming pose: sacrifice the oldest
                    self._drop_oldest(any_type=True)

    def _drop_oldest_frame(self) -> bool:
        return self._drop_oldest(any_type=False)

    def _drop_oldest(self, any_type: bool) -> bool:
        kept = []
        dropped = False
        try:
            while True:
                item = self._queue.get_nowait()
                if not dropped and (any_type or item[0] != T_POSE):
                    dropped = True
                    self.stats["dropped_frames"] += 1
                    self._dec_pending()
                else:
                    kept.append(item)
        except queue.Empty:
            pass
        for item in kept:
            self._queue.put_nowait(item)
        return dropped

    # -- fuse side ------------------------------------------------------
    def _fuse_loop(self) -> None:
        while not (self._stop.is_set() and self._queue.empty()):
            try:
                mtype, payload = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                self._dispatch(mtype, payload)
            except Exception as e:
                # a bad message (wrong camera size, pre-enable_stereo pair)
                # must not kill the service — count it and keep fusing (the
                # reference's callbacks likewise log and continue)
                self.stats["errors"] = self.stats.get("errors", 0) + 1
                self.stats["last_error"] = f"{type(e).__name__}: {e}"
            finally:
                self._dec_pending()

    def _dec_pending(self) -> None:
        with self._pending_cv:
            self._pending -= 1
            self._pending_cv.notify_all()

    def _dispatch(self, mtype: int, payload: bytes) -> None:
        with self._drv_lock:
            self._dispatch_locked(mtype, payload)

    def _dispatch_locked(self, mtype: int, payload: bytes) -> None:
        a = _unpack_arrays(payload)
        stamp = float(a["stamp"])
        if mtype == T_IMAGE:
            self.driver.feed_image(stamp, a["image"])
            self.stats["frames"] += 1
        elif mtype == T_DEPTH:
            self.driver.feed_depth(stamp, a["depth"])
        elif mtype == T_STEREO:
            self.driver.feed_stereo(stamp, a["left"], a["right"])
            self.stats["frames"] += 1
        elif mtype == T_POSE:
            ref = int(a["ref"])
            self.driver.feed_pose(
                stamp, a["pose"],
                loop_path=(list(a["loop_path"]) if "loop_path" in a
                           else None),
                loop_edges=[tuple(e) for e in a["edges"]],
                is_keyframe=bool(a["iskf"]),
                reference_index=None if ref < 0 else ref)
            self.stats["poses"] += 1

    def _control(self, mtype: int, payload: bytes) -> dict:
        body = json.loads(payload.decode()) if payload else {}
        try:
            if mtype == T_SAVE:
                self._drain()
                what = body.get("what", "mesh")
                path = body["path"]
                save = {"mesh": self.driver.save_mesh,
                        "cloud": self.driver.save_cloud,
                        "trajectory": self.driver.save_trajectory,
                        "checkpoint": self.driver.save_checkpoint}[what]
                with self._drv_lock:
                    n = save(path)
                return {"ok": True, "saved": path,
                        "count": None if n is None else int(n)}
            if mtype == T_METRICS:
                if body.get("drain", False):
                    self._drain()
                with self._drv_lock:
                    m = {k: float(v) for k, v in self.driver.metrics().items()}
                m.update({f"bridge_{k}": v for k, v in self.stats.items()})
                m["bridge_queued"] = self._queue.qsize()
                return {"ok": True, "metrics": m}
            if mtype == T_SHUTDOWN:
                self._drain()
                return {"ok": True, "stats": dict(self.stats)}
        except Exception as e:  # report to the client, keep serving
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
        return {"ok": False, "error": f"bad control type {mtype}"}

    def _drain(self, timeout: float = 120.0) -> None:
        """Block until the fuse thread has consumed everything accepted —
        control replies must reflect all frames sent before the request.
        Covers in-flight messages too (popped from the queue but whose
        feed_* has not returned), via the pending counter."""
        with self._pending_cv:
            self._pending_cv.wait_for(lambda: self._pending == 0, timeout)


def _listen(address) -> socket.socket:
    if isinstance(address, str) and "/" in address:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.bind(address)
    else:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(tuple(address))
    sock.listen(1)
    return sock
