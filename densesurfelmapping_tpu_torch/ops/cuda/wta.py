"""Wrapper of the stereo matcher's WTA kernel (`csrc/wta.cu`).

`wta_scan` returns the seven outputs of its plain twin,
`models/stereo.py::_wta_scan`, bitwise, and keeps the contract of
`kernel.py`: on a CPU tensor it runs that twin; on a CUDA tensor it checks
the inputs, launches `wta_scan_kernel` once on the current stream and
raises if the launch failed; it never falls back.  `LAUNCHES` counts the
launches.

The kernel replaces no TPU kernel: the JAX package runs this WTA as a
`lax.scan` over chunks of planes, which the twin translated op by op.

Stream axis: a (B, D', H, W) volume runs in one launch (grid z = stream),
and so does a call under `torch.func.vmap` (the stereo fleet's round,
`parallel/multistream.py`; a mesh cell's streams, `parallel/sharding.py`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import kernel
from .kernel import check, check_streams

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = kernel.Library("wta", {"wta_scan": [_P] * 9 + [_I] * 6 + [_P]},
                      ("wta_scan",))
LAUNCHES = _LIB.launches
reset_launch_counts = _LIB.reset_launch_counts
# planes whose loads a thread issues before their compare chains
# (csrc/wta.cu takes 1, 4, 8 or 16)
UNROLL = 8


def _launch_wta_scan(agg, min_d, subpixel, uniqueness, prior_plane=None,
                     unroll=UNROLL) -> tuple:
    """The kernel over a (D', H, W) or (B, D', H, W) f32 volume: the
    outputs of `wta_scan`, computing cm and cp only with subpixel, second
    only with the uniqueness gate and the prior's three costs only with a
    prior plane."""
    if min_d < 0:
        raise ValueError(f"min_d must be >= 0, got {min_d}")
    lead, nb = kernel.lead("agg", agg, "D, H, W")
    D, H, W = agg.shape[-3:]
    check_streams(nb)
    if not 1 <= H <= 65535:
        raise ValueError(f"{H} rows outside the grid's y range 1..65535")
    dev = agg.device
    ptr = check("agg", agg, torch.float32, lead + (D, H, W), dev)
    hw = lead + (H, W)
    prior_ptr = None
    if prior_plane is not None:
        prior_ptr = check("prior_plane", prior_plane, torch.int32, hw, dev)

    def empty(dtype=torch.float32, shape=hw):
        return torch.empty(shape, dtype=dtype, device=dev)

    idx, best, best_rd = empty(torch.int32), empty(), empty(torch.int32)
    cm, cp = (empty(), empty()) if subpixel else (None, None)
    second = empty() if uniqueness > 0 else None
    prior3 = empty(shape=(3,) + hw) if prior_plane is not None else None
    _LIB.launch("wta_scan", ptr, prior_ptr,
                *(t.data_ptr() if t is not None else None
                  for t in (idx, best, cm, cp, second, best_rd, prior3)),
                nb, D, H, W, int(min_d), int(unroll), kernel.stream(dev))
    return (idx, best, cm, cp, second, best_rd,
            tuple(prior3) if prior3 is not None else None)


def _twin(agg, min_d, subpixel, uniqueness, prior_plane=None):
    from ...models import stereo
    cfg = stereo.StereoConfig(min_disparity=min_d, subpixel=subpixel,
                              uniqueness_ratio=uniqueness)
    return stereo._wta_scan(agg, cfg, prior_plane)


def wta_scan(agg: torch.Tensor, min_d: int, subpixel: bool,
             uniqueness: float, prior_plane: Optional[torch.Tensor] = None):
    """The streaming WTA over an aggregated (D', H, W) f32 volume (plane k
    holds disparity k + min_d): (idx, best, cm, cp, second, bestR_d,
    prior3), as `models/stereo.py::_wta_scan` returns them; cm and cp None
    without subpixel, second None for a uniqueness ratio of 0, prior3 None
    without a prior plane ((H, W) i32, planes in [0, D'), else the costs at
    its planes p - 1, p, p + 1).  A (B, D', H, W) volume, or a call under
    torch.func.vmap, runs one launch for the B streams."""
    return kernel.dispatch(_twin, _launch_wta_scan, 3, agg, min_d, subpixel,
                           uniqueness, prior_plane)
