"""The port's `diagnose` probes and kernel-cache handling
(`utils/diagnostics.py`, `utils/cache.py`) on the CPU: the JAX package's
keys and verdict rule, the cache directory override, and which errors clear
the cached kernel libraries."""


import pytest
import torch

import densesurfelmapping_tpu as jdsm
from densesurfelmapping_tpu.config import CameraIntrinsics, SurfelMapConfig
from densesurfelmapping_tpu.utils import diagnostics as jdiag
from densesurfelmapping_tpu_torch import config as tcfg
from densesurfelmapping_tpu_torch.ops.cuda import build
from densesurfelmapping_tpu_torch.utils import cache
from densesurfelmapping_tpu_torch.utils import diagnostics as tdiag

torch.set_num_threads(1)

CAM = CameraIntrinsics(width=120, height=56, fx=80.0, fy=80.0, cx=59.5,
                       cy=27.5)
CFG = SurfelMapConfig(camera=CAM, surfel_capacity=8192)


@pytest.fixture
def kernel_dir_restored():
    yield
    cache._kernel_dir = cache.DEFAULT_DIR


def test_run_diagnostics_has_jax_keys(monkeypatch):
    """The JAX package's run_diagnostics on the same small camera gives
    the key set; the port's values have the same types, backend "cpu",
    and block_lies false (a CPU run is synchronous)."""
    monkeypatch.setattr(jdsm, "kitti_config", lambda **kw: CFG)
    want = jdiag.run_diagnostics(n_fuse=2)
    got = tdiag.run_diagnostics(
        n_fuse=2, device="cpu",
        config=tcfg.SurfelMapConfig.from_json(CFG.to_json()))
    assert set(got) == set(want) == {"backend", "dispatch_ms", "h2d_mbps",
                                     "fuse_ms", "block_lies", "healthy"}
    for k in want:
        assert type(got[k]) is type(want[k]), k
    assert got["backend"] == "cpu"
    assert got["block_lies"] is False
    assert got["fuse_ms"] > 0 and got["h2d_mbps"] > 0
    assert got["healthy"] == (got["dispatch_ms"] < 10.0
                              and got["h2d_mbps"] > 200.0
                              and got["fuse_ms"] < 20.0)


def test_enable_compilation_cache_honours_env(monkeypatch, tmp_path,
                                              kernel_dir_restored):
    monkeypatch.delenv("DSM_CACHE_DIR", raising=False)
    assert cache.enable_compilation_cache() == str(cache.DEFAULT_DIR)
    assert cache.DEFAULT_DIR.parts[-2:] == ("build", "kernels")
    monkeypatch.setenv("DSM_CACHE_DIR", str(tmp_path))
    backend = "cuda" if torch.cuda.is_available() else "cpu"
    path = cache.enable_compilation_cache()
    assert path == str(tmp_path / backend)
    assert cache.kernel_dir() == tmp_path / backend
    # an explicit path wins over the variable
    assert cache.enable_compilation_cache(str(tmp_path / "x")) == \
        str(tmp_path / "x" / backend)


@pytest.mark.parametrize("msg,stale", [
    ("CUDA error: no kernel image is available for execution on the "
     "device", True),
    ("slic_assign launch failed: invalid device function", True),
    ("build/kernels/slic_0123.so: undefined symbol: slic_assign", True),
    ("CUDA out of memory. Tried to allocate 2.00 GiB", False),
    ("nvcc failed on slic.cu", False),
])
def test_maybe_clear_stale_cache(tmp_path, kernel_dir_restored, msg, stale):
    d = cache.enable_compilation_cache(str(tmp_path))
    libs = [tmp_path / "cpu" / n for n in ("slic_0.so", "sgm_1.so")]
    if torch.cuda.is_available():
        libs = [tmp_path / "cuda" / n.name for n in libs]
    for lib in libs:
        lib.parent.mkdir(parents=True, exist_ok=True)
        lib.write_bytes(b"\0")
    keep = tmp_path / d / "notes.txt"
    keep.write_text("kept")
    build._loaded["probe"] = object()
    try:
        assert cache.maybe_clear_stale_cache(RuntimeError(msg)) is stale
        assert all(lib.exists() for lib in libs) is not stale
        assert ("probe" in build._loaded) is not stale
        assert keep.exists()
    finally:
        build._loaded.pop("probe", None)
