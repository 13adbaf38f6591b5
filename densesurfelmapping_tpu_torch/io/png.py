"""A small PNG reader in numpy + zlib, for machines without cv2 or PIL.

The dataset readers (`io/kitti.py`, `io/tum.py`) try cv2, then PIL, as the
JAX package's do, and fall back to this reader.  It reads the kinds that
KITTI and TUM ship and that `viz.save_png` writes: non-interlaced 8-bit
gray, 8-bit RGB and 16-bit gray, with the five scanline filters of the PNG
specification (section 9).  Any other kind raises ValueError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (bit depth, colour type) -> (samples per pixel, dtype of a sample)
_KINDS = {(8, 0): (1, np.dtype(np.uint8)), (8, 2): (3, np.dtype(np.uint8)),
          (16, 0): (1, np.dtype(">u2"))}


def read_png(path: str) -> np.ndarray:
    """(H, W) u8 or u16 gray, or (H, W, 3) u8 RGB, as PIL's np.asarray
    gives them."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _compression, _filter, interlace = header
    if (depth, ctype) not in _KINDS or interlace:
        raise ValueError(f"{path}: unsupported PNG kind (bit depth {depth}, "
                         f"colour type {ctype}, interlace {interlace})")
    spp, dtype = _KINDS[(depth, ctype)]
    bpp = spp * depth // 8                       # bytes per pixel
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {raw.size} bytes of image data for a "
                         f"{w} x {h} image")
    rows = raw.reshape(h, 1 + w * bpp)
    pixels = _unfilter(rows[:, 0], rows[:, 1:].reshape(h, w, bpp))
    img = pixels.reshape(-1).view(dtype).reshape(h, w, spp)
    img = img.astype(dtype.newbyteorder("=")) if depth == 16 else img
    return img[..., 0] if spp == 1 else img


def _unfilter(types: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Undo the scanline filters: (H,) filter types, (H, W, bpp) filtered
    bytes -> (H, W, bpp) u8.  A byte's predictor reads the reconstructed
    bytes to its left (a), above (b) and above-left (c), so the pass runs
    over the anti-diagonals y + x = k, each one vectorised over its rows:
    in the skewed layout S[k + 2, y + 1] = pixel (y, k - y), a diagonal is
    one row of S and a, b, c are slices of the two rows before it.  Cells
    outside the image hold 0, the predictors' border value, and stay 0."""
    if types.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(types.max())}")
    if not types.any():
        return filt
    h, w, bpp = filt.shape
    n_diag = h + w - 1
    ys, xs = np.mgrid[0:h, 0:w]
    f = np.zeros((n_diag + 2, h, bpp), np.int32)
    f[xs + ys + 2, ys] = filt
    s = np.zeros((n_diag + 2, h + 1, bpp), np.int32)
    t = types.astype(np.int32)[:, None]
    for k in range(2, n_diag + 2):
        a, b, c = s[k - 1, 1:], s[k - 1, :-1], s[k - 2, :-1]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(t == 0, 0, np.where(t == 1, a, np.where(
            t == 2, b, np.where(t == 3, (a + b) >> 1, paeth))))
        s[k, 1:] = (f[k] + pred) & 255
    return s[xs + ys + 2, ys + 1].astype(np.uint8)


def gray_u8(img: np.ndarray) -> np.ndarray:
    """8-bit gray of a `read_png` result: gray as it is, RGB to luma with
    PIL's `convert("L")` integer weights (ITU-R 601-2)."""
    if img.dtype != np.uint8:
        raise ValueError(f"not an 8-bit image ({img.dtype})")
    if img.ndim == 2:
        return img
    rgb = img.astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)
