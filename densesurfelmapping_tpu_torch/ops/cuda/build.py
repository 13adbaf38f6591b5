"""Build the port's CUDA sources (`csrc/*.cu`) at first use and load them.

Each source compiles with nvcc into a shared library with a plain C
interface, loaded with ctypes.  Libraries are cached in the directory of
`utils/cache.kernel_dir()` (`build/kernels/` at the repository root, or
`$DSM_CACHE_DIR/<backend>`), keyed by a hash of the source and the flags,
so a second process starts without compiling.  Nothing here runs at
import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ...utils import cache

CSRC = Path(__file__).resolve().parents[2] / "csrc"

# no --use_fast_math, and no FMA contraction: the kernels must round like
# their plain PyTorch twins, op by op
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_loaded: dict = {}
# compiler output (ptxas register/shared-memory report) of each library
# built by this process
build_logs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels cannot be built")
    return path


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`.  `signatures` maps each
    C entry point to its ctypes argtypes; every entry returns an int CUDA
    error code."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    build_dir = cache.kernel_dir()
    lib_path = build_dir / f"{name}_{key}.so"
    if not lib_path.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        build_logs[name] = proc.stdout + proc.stderr
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    _loaded[name] = lib
    return lib
