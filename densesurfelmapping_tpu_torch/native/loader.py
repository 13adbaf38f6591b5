"""ctypes loader (and on-demand build) of the native C++ host runtime.

`surfel_native.cpp` (the pack encoder, the PLY/PCD writers and the pose-graph
BFS; the same source as the JAX package's) exposes a plain C ABI loaded with
ctypes.  It is built with g++ at first use into `build/native/` at the
repository root, keyed by a hash of the source and the flags, as the CUDA
kernels are (`ops/cuda/build.py`).  If no compiler is present, `available()`
is False and every caller takes its numpy path: this is host serialization,
not the device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "surfel_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-mf16c", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _lib_path() -> Path:
    key = hashlib.sha256(_SRC.read_bytes()
                         + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libsurfelnative_{key}.so"


def build() -> bool:
    """Compile the native library with g++ unless a build of this source is
    cached (idempotent; safe across concurrent processes)."""
    so = _lib_path()
    if so.exists():
        return True
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not build():
            return None
        try:
            lib = ctypes.CDLL(str(_lib_path()))
        except OSError:
            return None
        lib.dsm_write_ply_mesh.restype = ctypes.c_int
        lib.dsm_write_ply_mesh.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int]
        lib.dsm_write_pcd.restype = ctypes.c_int
        lib.dsm_write_pcd.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int]
        lib.dsm_pack_frame.restype = ctypes.c_int
        lib.dsm_pack_frame.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]
        lib.dsm_pack_frames.restype = ctypes.c_int
        lib.dsm_pack_frames.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]
        lib.dsm_pack_frames_ptrs.restype = ctypes.c_int
        lib.dsm_pack_frames_ptrs.argtypes = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
        lib.dsm_bfs.restype = ctypes.c_int64
        lib.dsm_bfs.argtypes = [ctypes.POINTER(ctypes.c_int64)] * 2 \
            + [ctypes.c_int64] * 3 + [ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def write_ply_mesh(path: str, verts: np.ndarray, colors: np.ndarray,
                   faces: np.ndarray, binary: bool) -> None:
    lib = _load()
    verts = np.ascontiguousarray(verts, np.float32)
    colors = np.ascontiguousarray(colors, np.uint8)
    faces = np.ascontiguousarray(faces, np.int64)
    rc = lib.dsm_write_ply_mesh(
        path.encode(), _ptr(verts, ctypes.c_float),
        _ptr(colors, ctypes.c_uint8), len(colors),
        _ptr(faces, ctypes.c_int64), len(faces), int(binary))
    if rc:
        raise IOError(f"native PLY writer failed for {path}")


def write_pcd(path: str, xyzi: np.ndarray, binary: bool) -> None:
    lib = _load()
    xyzi = np.ascontiguousarray(xyzi, np.float32)
    rc = lib.dsm_write_pcd(path.encode(), _ptr(xyzi, ctypes.c_float),
                           len(xyzi), int(binary))
    if rc:
        raise IOError(f"native PCD writer failed for {path}")


def bfs(indptr: np.ndarray, indices: np.ndarray, root: int,
        radius: int) -> np.ndarray:
    lib = _load()
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    n = len(indptr) - 1
    out = np.zeros(n, np.int64)
    cnt = lib.dsm_bfs(_ptr(indptr, ctypes.c_int64),
                      _ptr(indices, ctypes.c_int64),
                      n, int(root), int(radius), _ptr(out, ctypes.c_int64))
    return out[:cnt]


def pack_frame(img: np.ndarray, dep: np.ndarray) -> np.ndarray:
    """f32 intensity + f32 depth -> packed (3*n,) u8 upload buffer."""
    lib = _load()
    img = np.ascontiguousarray(img, np.float32)
    dep = np.ascontiguousarray(dep, np.float32)
    if dep.size != img.size:
        raise ValueError(f"pack_frame: depth size {dep.size} != image size "
                         f"{img.size}")
    out = np.empty(3 * img.size, np.uint8)
    rc = lib.dsm_pack_frame(_ptr(img, ctypes.c_float),
                            _ptr(dep, ctypes.c_float),
                            img.size, _ptr(out, ctypes.c_uint8))
    if rc:
        raise RuntimeError("native pack_frame failed")
    return out


def pack_frames(imgs: np.ndarray, deps: np.ndarray) -> np.ndarray:
    """Batched encoder: (B, H, W) f32 intensity + depth -> (B, 3*H*W) u8,
    one native thread per frame (see dsm_pack_frames)."""
    lib = _load()
    imgs = np.ascontiguousarray(imgs, np.float32)
    deps = np.ascontiguousarray(deps, np.float32)
    if deps.shape != imgs.shape:
        raise ValueError(f"pack_frames: depths {deps.shape} != images "
                         f"{imgs.shape}")
    b = imgs.shape[0]
    n = imgs[0].size
    out = np.empty((b, 3 * n), np.uint8)
    rc = lib.dsm_pack_frames(_ptr(imgs, ctypes.c_float),
                             _ptr(deps, ctypes.c_float),
                             b, n, _ptr(out, ctypes.c_uint8))
    if rc:
        raise RuntimeError("native pack_frames failed")
    return out


def pack_frames_into(imgs, deps, out_rows) -> bool:
    """Pack B frames (lists of (H, W) f32 arrays) straight into B
    preallocated (3*H*W,) u8 destination views — no stacking copies.
    Returns False when the native library is not available (the caller
    takes its numpy path)."""
    lib = _load()
    if lib is None:
        return False
    b = len(imgs)
    imgs = [np.ascontiguousarray(i, np.float32) for i in imgs]
    deps = [np.ascontiguousarray(d, np.float32) for d in deps]
    n = imgs[0].size
    for r in out_rows:
        if not (r.dtype == np.uint8 and r.size == 3 * n
                and r.flags["C_CONTIGUOUS"]):
            raise ValueError("pack_frames_into: each destination must be a "
                             f"contiguous ({3 * n},) u8 array")
    for i, d in zip(imgs, deps):
        if i.size != n or d.size != n:
            raise ValueError("pack_frames_into: frames differ in size")
    PF = ctypes.POINTER(ctypes.c_float)
    PU = ctypes.POINTER(ctypes.c_uint8)
    ip = (PF * b)(*[i.ctypes.data_as(PF) for i in imgs])
    dp = (PF * b)(*[d.ctypes.data_as(PF) for d in deps])
    op = (PU * b)(*[r.ctypes.data_as(PU) for r in out_rows])
    rc = lib.dsm_pack_frames_ptrs(ip, dp, b, n, op)
    if rc:
        raise RuntimeError("native pack_frames_ptrs failed")
    return True
