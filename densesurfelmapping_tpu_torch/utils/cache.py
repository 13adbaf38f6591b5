"""Where the built CUDA kernels are cached, and recovery from a stale cache.

Counterpart of the JAX package's `utils/cache.py`, which points JAX's
persistent compilation cache at a directory.  The port's compiled artefacts
are the kernel libraries that `ops/cuda/build.py` builds with nvcc at first
use: by default under `build/kernels/` at the repository root, or under
`$DSM_CACHE_DIR/<backend>` once `enable_compilation_cache()` has run with
that variable set.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

_kernel_dir = DEFAULT_DIR


def kernel_dir() -> Path:
    """The directory the kernel libraries are built into and loaded from."""
    return _kernel_dir


def enable_compilation_cache(path: str | None = None) -> str:
    """Point the kernel build directory at `path/<backend>` (default: the
    `$DSM_CACHE_DIR` variable; without it the directory stays
    `build/kernels/`).  The backend is `cuda` on a machine with a CUDA
    card, else `cpu`.  Idempotent; returns the directory."""
    global _kernel_dir
    import torch

    if path is None:
        path = os.environ.get("DSM_CACHE_DIR")
    if path is None:
        _kernel_dir = DEFAULT_DIR
    else:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
        _kernel_dir = Path(path) / backend
    return str(_kernel_dir)


# Error-message fragments that mean a cached library does not fit this
# machine or this build (built for another card, or against another version
# of its source's entry points): the fix is to drop the libraries and
# build anew, not to load the same file again.
_STALE_MARKERS = (
    "no kernel image is available",
    "invalid device function",
    "undefined symbol",
)


def maybe_clear_stale_cache(exc: BaseException) -> bool:
    """If `exc` names a stale kernel library, delete the cached libraries
    (`*.so` in the kernel directory) and forget the loaded ones, so that
    the next kernel call builds afresh.  Returns True if it cleared."""
    from ..ops.cuda import build

    msg = f"{type(exc).__name__}: {exc}".lower()
    if not any(m in msg for m in _STALE_MARKERS):
        return False
    for lib in kernel_dir().glob("*.so"):
        lib.unlink(missing_ok=True)
    build._loaded.clear()
    return True
