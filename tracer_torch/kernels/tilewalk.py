"""The work plan and the packed result keys of the two tile walks,
``tilecull_cuda`` and ``cull_cuda`` (``csrc/tilewalk.cuh``).

Both kernels split each row of listed tiles (a 128-ray block's: one
subpacket for the tile cull, one eighth of a 1024-ray packet for the packet
cull) into work items of at most ``CHUNK`` listed tiles, walk the items on a
persistent grid, and merge each ray's best hit with an ``atomicMin`` on a
64-bit key, (float bits of t) << 32 | index. An accepted t is positive, so
its bits order like the floats and the minimum key is the smallest t, then
the lowest index. The wrappers make the plan, initialise the keys and
unpack them with the torch functions here, on the device and without a
host sync; the tests hold the same functions against a numpy enumeration
and a split-and-merge model built from the plain walks.

The leaf walks (``csrc/leafwalk.cuh``) plan their items with the same
:func:`plan_items`, over the walked leaves of each row
(``leafcull.walked_leaves``) and ``leafcull.item_leaves`` leaves per item.
"""

from __future__ import annotations

import struct

import torch
from torch import Tensor

CHUNK = 4   # W, listed tiles per item: the fastest of 4, 8, 16 on the card
_LOW = 0xFFFFFFFF


def miss_key(t: float, idx: int) -> int:
    """The key of a miss reported as (t, idx): t rounded to float32."""
    return struct.unpack("<I", struct.pack("<f", t))[0] << 32 | idx


def pack_keys(t: Tensor, idx: Tensor) -> Tensor:
    """int64 keys of positive float32 ``t`` and 32-bit unsigned ``idx``."""
    bits = t.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    return bits << 32 | (idx.to(torch.int64) & _LOW)


def unpack_keys(keys: Tensor):
    """int64 keys -> (t float32, idx int64), the inverse of
    :func:`pack_keys`."""
    t = (keys >> 32).to(torch.int32).view(torch.float32)
    return t, keys & _LOW


def plan_items(walked: Tensor, chunk: int = CHUNK) -> Tensor:
    """The item plan of rows that walk ``walked`` (R,) listed tiles each:
    starts (R + 1,) int32, row r owning items starts[r] .. starts[r + 1] - 1,
    ceil(walked[r] / chunk) of them; starts[R] is the total. Stays on the
    device (no host sync)."""
    items = torch.div(walked.reshape(-1).to(torch.int32) + (chunk - 1), chunk,
                      rounding_mode="floor")
    starts = torch.zeros(items.numel() + 1, dtype=torch.int32,
                         device=walked.device)
    starts[1:] = torch.cumsum(items, 0, dtype=torch.int32)
    return starts


def item_table(starts: Tensor, walked: Tensor, chunk: int = CHUNK):
    """Every item of a plan as the kernel reads it: (row, first listed
    position, number of tiles), each (items,) int64; row = the largest r with
    starts[r] <= item. Sizes its output on the host: for tests and logs."""
    total = int(starts[-1])
    item = torch.arange(total, device=starts.device)
    row = torch.searchsorted(starts[:-1].to(torch.int64), item,
                             right=True) - 1
    first = (item - starts[row].to(torch.int64)) * chunk
    n = torch.clamp(walked.reshape(-1).to(torch.int64)[row] - first,
                    max=chunk)
    return row, first, n

