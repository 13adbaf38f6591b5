"""The port's socket bridge (`densesurfelmapping_tpu_torch/io/bridge.py`)
serving the port's drivers on the CPU, in the style of tests/test_bridge.py:
the wire format byte for byte against the JAX package's, the map served
over a socket against an in-process feed, a JAX client driving a port server
and a port client driving a JAX server, the queue-drop policy, the drain of
an in-flight message, control requests, reconnects and unix sockets.

Tolerances: wire bytes exact; the served map equals the in-process one
(update_times exact, floats bitwise); across packages positions within
1e-5 m and the surfel count exact (the JAX fleet's tolerance)."""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from densesurfelmapping_tpu.io import bridge as jbridge
from densesurfelmapping_tpu.pipeline.device_driver import (
    DeviceResidentMapping as JaxDeviceResidentMapping)
import densesurfelmapping_tpu_torch.config as tcfg
from densesurfelmapping_tpu_torch.core.state import bank_to_numpy
from densesurfelmapping_tpu_torch.io import bridge
from densesurfelmapping_tpu_torch.pipeline.device_driver import (
    DeviceResidentMapping)
from densesurfelmapping_tpu_torch.pipeline.driver import SurfelMapping

from test_driver import tiny_config, render_plane, feed_frame

torch.set_num_threads(1)

REF = tiny_config()


def port_driver(cls=DeviceResidentMapping):
    return cls(tcfg.SurfelMapConfig.from_json(REF.to_json()), device="cpu")


def _serve_in_thread(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


def _frame(i):
    pose = np.eye(4)
    pose[0, 3] = 0.05 * i
    img, dep = render_plane(REF, pose)
    return pose, img, dep


def _stream(client, n_frames, start=0, kf_every=2):
    for i in range(start, start + n_frames):
        pose, img, dep = _frame(i)
        client.publish_pose(float(i), pose, is_keyframe=(i % kf_every == 0))
        client.publish_image(float(i), img)
        client.publish_depth(float(i), dep)


def _direct(driver, n_frames):
    for i in range(n_frames):
        pose, img, dep = _frame(i)
        feed_frame(driver, float(i), pose, img, dep,
                   is_keyframe=(i % 2 == 0))
    return driver


def _served(driver, client_mod, server_mod, n_frames, address=None):
    with server_mod.MappingServer(driver, address or ("127.0.0.1", 0)) \
            as server:
        _serve_in_thread(server)
        addr = server.address if isinstance(server.address, str) \
            else tuple(server.address)
        with client_mod.MappingClient(addr) as client:
            _stream(client, n_frames)
            m = client.metrics()["metrics"]
    return driver, m


def _sorted(rows):
    order = np.lexsort(rows["position"].T)
    return {k: v[order] for k, v in rows.items()}


# ---------------------------------------------------------------------------
def test_wire_format_is_the_jax_packages_byte_for_byte():
    """Header and npz payload as the JAX bridge writes them; each side
    decodes the other's messages."""
    arrays = dict(stamp=np.float64(1.5),
                  image=np.arange(12, dtype=np.uint8).reshape(3, 4))
    assert bridge._pack_arrays(**arrays) == jbridge._pack_arrays(**arrays)
    assert bridge._HEADER.format == jbridge._HEADER.format
    assert bridge._MAGIC == jbridge._MAGIC
    for name in ("T_IMAGE", "T_DEPTH", "T_STEREO", "T_POSE", "T_SAVE",
                 "T_METRICS", "T_SHUTDOWN", "T_REPLY"):
        assert getattr(bridge, name) == getattr(jbridge, name), name
    for send, recv in ((bridge, jbridge), (jbridge, bridge)):
        a, b = socket.socketpair()
        send._send_msg(a, send.T_IMAGE, send._pack_arrays(**arrays))
        mtype, got = recv._recv_msg(b)
        assert mtype == recv.T_IMAGE
        back = recv._unpack_arrays(got)
        assert float(back["stamp"]) == 1.5
        np.testing.assert_array_equal(back["image"], arrays["image"])
        a.close(), b.close()


def test_bad_magic_is_refused():
    a, b = socket.socketpair()
    a.sendall(b"XXXX" + bytes(12))
    with pytest.raises(ValueError, match="bad magic"):
        bridge._recv_msg(b)
    a.close(), b.close()


def test_bridge_matches_inprocess_driver():
    """The map built over the socket equals the map built by direct feeds:
    the bridge adds transport, not semantics (the fuse thread feeds the
    driver)."""
    n = 6
    direct = _direct(port_driver(), n)
    served, m = _served(port_driver(), bridge, bridge, n)
    assert m["bridge_frames"] == n and m["bridge_poses"] == n
    assert m["frames_fused"] == direct.frames_fused == n
    a, b = bank_to_numpy(direct.bank), bank_to_numpy(served.bank)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("client_pkg", ["jax", "port"])
def test_cross_package_client_and_server(client_pkg):
    """A JAX MappingClient drives a port server, and a port client drives a
    JAX server: both maps equal the other package's in-process map."""
    n = 6
    if client_pkg == "jax":
        served, m = _served(port_driver(), jbridge, bridge, n)
        got = served.map_surfels()
        want = _direct(JaxDeviceResidentMapping(REF), n).map_surfels()
    else:
        served, m = _served(JaxDeviceResidentMapping(REF), bridge, jbridge,
                            n)
        got = {k: np.asarray(v) for k, v in served.map_surfels().items()}
        want = _direct(port_driver(), n).map_surfels()
    assert m["frames_fused"] == n
    got, want = _sorted(got), _sorted(want)
    assert len(got["position"]) == len(want["position"]) > 0
    np.testing.assert_allclose(got["position"], want["position"], atol=1e-5)
    np.testing.assert_array_equal(got["update_times"], want["update_times"])


def test_control_save_and_metrics(tmp_path):
    served = port_driver(SurfelMapping)
    with bridge.MappingServer(served, ("127.0.0.1", 0)) as server:
        _serve_in_thread(server)
        with bridge.MappingClient(tuple(server.address)) as client:
            _stream(client, 8)  # > 5 updates: stable, mesh-eligible
            mesh = tmp_path / "live_mesh.ply"
            r = client.save_map(str(mesh), what="mesh")
            assert r["ok"] and mesh.exists() and r["count"] > 0
            ck = tmp_path / "live.ckpt.npz"
            r = client.save_map(str(ck), what="checkpoint")
            assert r["ok"] and ck.exists()
            r = client.shutdown()
            assert r["ok"] and r["stats"]["frames"] == 8
    resumed = port_driver(SurfelMapping)
    resumed.load_checkpoint(str(ck))
    assert resumed.frames_fused == served.frames_fused == 8


def test_save_error_reported_not_fatal():
    with bridge.MappingServer(port_driver(), ("127.0.0.1", 0)) as server:
        _serve_in_thread(server)
        with bridge.MappingClient(tuple(server.address)) as client:
            _stream(client, 2)
            with pytest.raises(RuntimeError):
                client.save_map("/nonexistent-dir/x.ply", what="mesh")
            assert client.metrics()["metrics"]["frames_fused"] == 2


def test_bad_message_counted_not_fatal():
    """A frame of the wrong camera size raises in the driver's feed: the
    fuse thread counts it and keeps serving."""
    with bridge.MappingServer(port_driver(), ("127.0.0.1", 0)) as server:
        _serve_in_thread(server)
        with bridge.MappingClient(tuple(server.address)) as client:
            client.publish_image(0.0, np.zeros((3, 3), np.float32))
            _stream(client, 2)
            m = client.metrics()["metrics"]
    assert m["bridge_errors"] == 1 and m["frames_fused"] == 2


class _GatedDriver:
    """Driver stub whose feed calls block on an event: backs the ingest
    queue up deterministically."""

    def __init__(self):
        self.gate = threading.Event()
        self.calls = []

    def _feed(self, kind, stamp):
        self.gate.wait(30.0)
        self.calls.append((kind, float(stamp)))

    def feed_image(self, stamp, image):
        self._feed("image", stamp)

    def feed_depth(self, stamp, depth):
        self._feed("depth", stamp)

    def feed_pose(self, stamp, pose, **kw):
        self._feed("pose", stamp)

    def metrics(self):
        return {"frames_fused": 0.0}

    def save_mesh(self, path):
        return 0


def test_queue_overflow_drops_frames_not_poses():
    stub = _GatedDriver()
    server = bridge.MappingServer(stub, ("127.0.0.1", 0), queue_depth=4)
    try:
        with bridge.MappingClient(tuple(server.address)) as client:
            _serve_in_thread(server)
            pose, img, dep = _frame(0)
            for i in range(8):
                client.publish_pose(float(i), pose, is_keyframe=(i == 0))
                client.publish_image(float(i), img)
                client.publish_depth(float(i), dep)
            deadline = time.monotonic() + 20
            while (server.stats["received"] < 24
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            assert server.stats["received"] == 24
            assert server.stats["dropped_frames"] > 0
            queued = [t for t, _ in list(server._queue.queue)]
            assert queued and all(t == bridge.T_POSE for t in queued)
        stub.gate.set()
    finally:
        stub.gate.set()
        server.shutdown()
    fed_poses = [s for k, s in stub.calls if k == "pose"]
    assert fed_poses == sorted(fed_poses)


class _WindowServer(bridge.MappingServer):
    """Holds the fuse thread between queue.get and the driver feed: the
    queue is empty but the message is not fused yet."""

    window = None

    def _dispatch(self, mtype, payload):
        self.window.wait(30.0)
        super()._dispatch(mtype, payload)


def test_drain_covers_inflight_message():
    stub = _GatedDriver()
    stub.gate.set()
    server = _WindowServer(stub, ("127.0.0.1", 0))
    server.window = threading.Event()
    try:
        with bridge.MappingClient(tuple(server.address)) as client:
            _serve_in_thread(server)
            client.publish_image(0.0, _frame(0)[1])
            deadline = time.monotonic() + 20
            while ((server.stats["received"] < 1 or not server._queue.empty()
                    or server._pending == 0) and time.monotonic() < deadline):
                time.sleep(0.005)
            assert server._queue.empty() and server._pending == 1
            got = {}
            t = threading.Thread(
                target=lambda: got.update(client.metrics(drain=True)))
            t.start()
            time.sleep(0.3)
            assert not got and not stub.calls
            server.window.set()
            t.join(30.0)
            assert got["metrics"]["bridge_frames"] == 1
            assert stub.calls == [("image", 0.0)]
    finally:
        server.window.set()
        server.shutdown()


def test_reconnect_resumes_live_map():
    served = port_driver()
    with bridge.MappingServer(served, ("127.0.0.1", 0)) as server:
        _serve_in_thread(server)
        with bridge.MappingClient(tuple(server.address)) as client:
            _stream(client, 3)
            client.metrics()
        with bridge.MappingClient(tuple(server.address)) as client:
            _stream(client, 3, start=3)
            m = client.metrics()["metrics"]
    assert m["frames_fused"] == 6
    assert m["bridge_reconnects"] == 2


def test_unix_socket_transport(tmp_path):
    path = str(tmp_path / "dsm.sock")
    served, m = _served(port_driver(), bridge, bridge, 2, address=path)
    assert m["frames_fused"] == 2


def test_cli_serve_and_publish_over_a_unix_socket(tmp_path):
    """The port's `serve` (on the CPU, the 120 x 56 camera) in a thread, fed
    by the port's `publish ... --save ... --shutdown`: the saved mesh and
    the autosave are written."""
    import os
    from densesurfelmapping_tpu.config import (CameraIntrinsics,
                                               SurfelMapConfig)
    from densesurfelmapping_tpu_torch import cli

    cam = CameraIntrinsics(width=120, height=56, fx=80.0, fy=80.0, cx=59.5,
                           cy=27.5)
    cam_json = tmp_path / "cam.json"
    cam_json.write_text(SurfelMapConfig(camera=cam,
                                        surfel_capacity=8192).to_json())
    sock = str(tmp_path / "s.sock")
    out = str(tmp_path / "served")
    rc = {}
    t = threading.Thread(target=lambda: rc.update(serve=cli.main(
        ["serve", "--socket", sock, "--camera-json", str(cam_json),
         "--device", "cpu", "--kf-every", "2", "--out", out])))
    t.start()
    deadline = time.monotonic() + 30
    while not os.path.exists(sock) and time.monotonic() < deadline:
        time.sleep(0.02)
    mesh = str(tmp_path / "live_mesh.ply")
    assert cli.main(["publish", "--socket", sock, "--frames", "6",
                     "--kf-every", "2", "--width", "120", "--height", "56",
                     "--fx", "80", "--fy", "80", "--cx", "59.5", "--cy",
                     "27.5", "--save", mesh, "--shutdown"]) == 0
    t.join(60)
    assert rc["serve"] == 0
    assert os.path.getsize(mesh) > 0
    assert os.path.getsize(out + "_mesh.ply") > 0
    assert int(np.load(out + ".ckpt.npz")["frames_fused"]) == 6
