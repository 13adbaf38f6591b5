"""The PyTorch port stands alone: no module of it imports jax or the JAX
package, and its configs, frame codecs and bank state interoperate with the
JAX package's."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import densesurfelmapping_tpu.config as jcfg
from densesurfelmapping_tpu.core import state as jstate
import densesurfelmapping_tpu_torch.config as tcfg
from densesurfelmapping_tpu_torch.core import state as tstate
from densesurfelmapping_tpu_torch.pipeline import fuse_step

from test_driver import tiny_config

torch.set_num_threads(1)

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import densesurfelmapping_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"modules": names, "jax": "jax" in sys.modules,
                  "reference": "densesurfelmapping_tpu" in sys.modules}))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                         capture_output=True, text=True, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(res["modules"]) >= 15, res["modules"]
    for name in ("cli", "__main__", "eval.fidelity", "native.loader",
                 "io.export", "io.png", "io.kitti", "io.tum", "io.posefeed",
                 "io.stressfeed", "viz", "io.bridge", "parallel.multistream",
                 "pipeline.multi_session"):
        assert f"densesurfelmapping_tpu_torch.{name}" in res["modules"], name
    assert not res["jax"]
    assert not res["reference"]


_STEREO_MODULES = ("models.stereo", "ops.sgm", "ops.cuda.sgm", "ops.render",
                   "ops.depthfilter")


def test_stereo_modules_import_without_jax():
    """The stereo slice's modules import on their own without jax; the
    wrapper module builds no kernel at import."""
    code = ("import importlib, json, sys\n"
            f"names = {list(_STEREO_MODULES)!r}\n"
            "for n in names:\n"
            "    importlib.import_module('densesurfelmapping_tpu_torch.' + n)\n"
            "from densesurfelmapping_tpu_torch.ops.cuda import build\n"
            "print(json.dumps({'jax': 'jax' in sys.modules,\n"
            "                  'loaded': sorted(build._loaded)}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert not res["jax"]
    assert res["loaded"] == []


_BLOCK_JAX = """
import importlib, importlib.abc, json, sys

class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib", "flax")):
            raise ImportError(f"{name} is unimportable here")
        return None

sys.meta_path.insert(0, NoJax())
try:
    import jax  # noqa: F401
except ImportError:
    blocked = True
else:
    blocked = False
mod = importlib.import_module("densesurfelmapping_tpu_torch." + sys.argv[1])
print(json.dumps({"blocked": blocked, "file": mod.__file__,
                  "jax": "jax" in sys.modules,
                  "reference": "densesurfelmapping_tpu" in sys.modules}))
"""


@pytest.mark.parametrize("name", ["parallel.multistream",
                                  "pipeline.multi_session", "io.bridge"])
def test_serving_modules_import_with_jax_unimportable(name):
    """The serving slice's modules import with jax made unimportable (an
    import hook refuses it), as on the GPU machine, which has no jax."""
    out = subprocess.run([sys.executable, "-c", _BLOCK_JAX, name],
                         capture_output=True, text=True, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["blocked"]
    assert res["file"].endswith(name.replace(".", "/") + ".py")
    assert not res["jax"] and not res["reference"]


@pytest.mark.parametrize("size", [(48, 64), (47, 63)])
def test_batched_payload_decode(size):
    """multistream.unpack_payload and the batched step's frame decode
    recover each row of a (B, 3 H W + 72 + P) payload as the single-frame
    decode does, also when the row's fields start at unaligned offsets."""
    from densesurfelmapping_tpu_torch.parallel import multistream
    h, w = size
    cam = tcfg.CameraIntrinsics(width=w, height=h, fx=60.0, fy=60.0,
                                cx=w / 2, cy=h / 2)
    cfg = tcfg.SurfelMapConfig(camera=cam, surfel_capacity=256,
                               lane_align=8, max_keyframes=8)
    rows = []
    for k in range(3):
        img, dep = _frame(h, w, 10 + k)
        pose = np.arange(16, dtype=np.float32).reshape(4, 4) + k
        mask = np.arange(8) % (k + 2) == 0
        rows.append(tstate.pack_frame_with_aux(
            cfg, img, dep, tstate.pack_aux(pose, 3 + k, mask, bf=0.5 * k)))
    payload = torch.from_numpy(np.stack(rows))
    hw3 = 3 * h * w
    frames, poses, refs, bf, masks = multistream.unpack_payload(
        payload, hw3)
    for k in range(3):
        p, ref, b, m = fuse_step.unpack_aux(payload[k, hw3:])
        assert torch.equal(poses[k], p) and int(refs[k]) == int(ref)
        assert float(bf[k]) == float(b) and torch.equal(masks[k], m)
        assert torch.equal(frames[k], payload[k, :hw3])


def test_tf32_off_at_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("preset", ["kitti_config", "rgbd_config",
                                    "mono_config", "tiny"])
def test_config_json_roundtrip(preset):
    if preset == "tiny":
        ref = tiny_config(compact_interval=4)
        ported = tcfg.SurfelMapConfig.from_json(ref.to_json())
    else:
        ref = getattr(jcfg, preset)(surfel_capacity=1 << 12)
        ported = getattr(tcfg, preset)(surfel_capacity=1 << 12)
        assert tcfg.SurfelMapConfig.from_json(ref.to_json()) == ported
    assert jcfg.SurfelMapConfig.from_json(ported.to_json()) == ref
    for prop in ("padded_height", "padded_width", "sp_rows", "sp_cols",
                 "num_seeds", "new_capacity"):
        assert getattr(ported, prop) == getattr(ref, prop), prop


def _frame(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-10, 280, (h, w)).astype(np.float32)
    dep = rng.uniform(0, 40, (h, w)).astype(np.float32)
    dep[0, 0] = np.inf
    dep[1, 1] = 0.0
    return img, dep


def test_pack_frame_with_aux_matches_jax_bitwise():
    ref = tiny_config(max_keyframes=16)
    cfg = tcfg.SurfelMapConfig.from_json(ref.to_json())
    img, dep = _frame(cfg.height, cfg.width, 0)
    pose = np.random.default_rng(1).normal(size=(4, 4)).astype(np.float32)
    mask = np.arange(16) % 3 == 0
    want = jstate.pack_frame_with_aux(ref, img, dep,
                                      jstate.pack_aux(pose, 5, mask, bf=2.5))
    got = tstate.pack_frame_with_aux(cfg, img, dep,
                                     tstate.pack_aux(pose, 5, mask, bf=2.5))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [(48, 64), (47, 63)])
def test_onebuf_decode(size):
    """unpack_frame/unpack_aux recover the encoded frame, also when H*W is
    odd and the f16/f32 fields start at unaligned byte offsets."""
    h, w = size
    cam = tcfg.CameraIntrinsics(width=w, height=h, fx=60.0, fy=60.0,
                                cx=w / 2, cy=h / 2)
    cfg = tcfg.SurfelMapConfig(camera=cam, surfel_capacity=256,
                               lane_align=8, max_keyframes=8)
    img, dep = _frame(h, w, 2)
    pose = np.arange(16, dtype=np.float32).reshape(4, 4)
    mask = np.array([1, 0, 1, 1, 0, 0, 0, 1], bool)
    buf = torch.from_numpy(tstate.pack_frame_with_aux(
        cfg, img, dep, tstate.pack_aux(pose, 7, mask, bf=1.5)))
    hw3 = 3 * h * w
    i8, d16 = fuse_step.unpack_frame(cfg, buf[:hw3])
    ci, cd = tstate.compact_frame(cfg, img, dep)
    np.testing.assert_array_equal(i8.numpy(), ci)
    np.testing.assert_array_equal(d16.numpy().view(np.uint16),
                                  cd.view(np.uint16))
    p, ref, bf, m = fuse_step.unpack_aux(buf[hw3:])
    np.testing.assert_array_equal(p.numpy(), pose)
    assert int(ref) == 7 and float(bf) == 1.5
    np.testing.assert_array_equal(m.numpy(), mask)


def test_bank_numpy_roundtrip():
    rng = np.random.default_rng(3)
    n = 37
    fields = dict(
        position=rng.normal(size=(n, 3)).astype(np.float32),
        normal=rng.normal(size=(n, 3)).astype(np.float32),
        color=rng.uniform(0, 255, n).astype(np.float32),
        size=rng.uniform(0, 1, n).astype(np.float32),
        weight=rng.uniform(0, 1, n).astype(np.float32),
        update_times=rng.integers(0, 9, n).astype(np.int32),
        last_update=rng.integers(-1, 9, n).astype(np.int32))
    bank = tstate.bank_from_numpy(fields, n, "cpu", 64)
    assert bank.capacity == 64 and int(bank.count) == n
    back = tstate.bank_to_numpy(bank)
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert int(bank.last_update[n:].max()) == -1
    # readouts are copies, never views of the live bank
    back["position"][:] = 0
    assert float(bank.position[:n].abs().sum()) > 0
    with pytest.raises(ValueError):
        tstate.bank_from_numpy(fields, n, "cpu", 16)
