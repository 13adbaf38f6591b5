"""Active -> inactive migration on the device.

Counterpart of the JAX package's `ops/migration.py` (the reference's
`SurfelMap::move_add_surfels`, `surfel_map.cpp:1456-1595`): one pass matches
every removed pose at once, compacts the matches into a fixed-size
migration buffer (one device-to-host slab) and kills them in the bank.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.state import FIELDS, SurfelBank

# number of pose ids matchable per extraction call (padded, static)
MAX_REMOVE_POSES = 32


def extract_by_pose(bank: SurfelBank, pose_ids: torch.Tensor,
                    buffer_size: int) -> Tuple[dict, torch.Tensor]:
    """Remove live surfels whose last_update is in pose_ids (padded with -1,
    shape (MAX_REMOVE_POSES,)), in place.

    Matches the reference's removal criterion `update_times > 0 &&
    last_update == inactive_index` (`surfel_map.cpp:1479-1497`).  Returns
    (buffer dict of extracted fields sized `buffer_size`, match count).
    Matches beyond buffer_size stay in the bank for a follow-up call.
    """
    match = bank.live_mask & (
        bank.last_update[:, None] == pose_ids[None, :]).any(dim=-1)

    dest = torch.cumsum(match.to(torch.int32), 0) - 1
    extracted = match & (dest < buffer_size)
    # unmatched rows go to the spare row buffer_size, which is dropped
    dest = torch.where(extracted, dest, buffer_size).long()
    n = extracted.sum(dtype=torch.int32)

    buf = {}
    for k in FIELDS:
        arr = getattr(bank, k)
        # out of place: under torch.func.vmap (a mesh cell's streams) the
        # zeros are not batched
        slab = torch.zeros((buffer_size + 1,) + arr.shape[1:],
                           dtype=arr.dtype, device=arr.device
                           ).index_copy(0, dest, arr)
        buf[k] = slab[:buffer_size]

    # kill extracted rows in place; holes are reclaimed by compact_bank
    bank.update_times.copy_(torch.where(extracted, 0, bank.update_times))
    return buf, n
