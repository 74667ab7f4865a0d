"""Octahedral ray sorting and cell bucket-padding for packet coherence.

PyTorch counterpart of the parts of ``tracer/core/sort.py`` that the
closest-hit query runs. The cull stages treat every ``subpacket``
consecutive rays as one frustum, so rays are sorted by a Morton code of the
octahedral direction map and padded at coarse code-cell boundaries, which
keeps every subpacket inside one narrow direction cell.

The codes are uint32 in the reference; here they live in int64 masked to
32 bits, which sorts identically and keeps to ops torch covers for int64.
"""

from __future__ import annotations

import torch
from torch import Tensor


def _part_bits16(v: Tensor) -> Tensor:
    """Spread 16 bits of v over 32 bits (1 zero bit between each); int64."""
    v = v.to(torch.int64) & 0xFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def octahedral_codes(d: Tensor) -> Tensor:
    """32-bit Morton code of the octahedral direction map, (B,) int64 in
    [0, 2^32). 16 bits per octahedral axis."""
    ad = torch.abs(d)
    s = ad[:, 0] + ad[:, 1] + ad[:, 2]
    u = d[:, 0] / s
    v = d[:, 1] / s
    neg = d[:, 2] < 0
    uu = torch.where(neg, (1 - torch.abs(v)) * torch.sign(u), u)
    vv = torch.where(neg, (1 - torch.abs(u)) * torch.sign(v), v)
    qu = torch.clamp((uu * 0.5 + 0.5) * 65535, 0, 65535).to(torch.int64)
    qv = torch.clamp((vv * 0.5 + 0.5) * 65535, 0, 65535).to(torch.int64)
    return _part_bits16(qu) | (_part_bits16(qv) << 1)


def plan_bucket_pad(sorted_codes: Tensor, subpacket: int,
                    cell_bits: int = 8):
    """Padding plan for a code-sorted ray stream.

    sorted_codes: (B,) int64, ascending. Returns (src, dest), both int64:
    src (Bp,) maps each padded slot to its source ray (padding slots
    replicate the previous real ray of their cell), dest (B,) maps each
    input ray to its padded slot; Bp = B + 2^cell_bits * subpacket (static).

    Cell bounds come from ncells+1 searchsorted queries; per-slot tables are
    built by scattering the ncells segment deltas and one shared cumsum.
    Empty cells repeat indices, so the scatter accumulates (index_add_).
    """
    b = sorted_codes.shape[0]
    dev = sorted_codes.device
    ncells = 1 << cell_bits
    cid = torch.arange(ncells, dtype=torch.int64, device=dev)
    queries = torch.cat([cid << (32 - cell_bits),
                         torch.tensor([0xFFFFFFFF], dtype=torch.int64,
                                      device=dev)])
    bounds = torch.searchsorted(sorted_codes, queries, side="left")
    bounds[-1] = b
    cnt = bounds[1:] - bounds[:-1]
    start = bounds[:-1]
    pad = (subpacket - cnt % subpacket) % subpacket
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    pad_before = torch.cat([zero, torch.cumsum(pad, 0)[:-1]])
    bp = b + ncells * subpacket
    # Padded cell c occupies [pstart[c], pstart[c+1]); both ends are
    # subpacket-aligned, so no subpacket straddles two cells.
    pstart = start + pad_before
    cap = start + torch.clamp(cnt - 1, min=0)   # last real ray of the cell
    d_shift = torch.diff(pad_before, prepend=zero)
    d_cap = torch.diff(cap, prepend=zero)
    rows = torch.zeros((3, bp), dtype=torch.int64, device=dev)
    rows[0].index_add_(0, pstart, d_shift)      # pad_before per slot
    rows[1].index_add_(0, pstart, d_cap)        # cap per slot
    rows[2].index_add_(0, start, d_shift)       # pad_before per element
    cum = torch.cumsum(rows, dim=1)
    pos = torch.arange(bp, dtype=torch.int64, device=dev)
    src = torch.clamp(torch.minimum(pos - cum[0], cum[1]), 0, b - 1)
    dest = torch.arange(b, dtype=torch.int64, device=dev) + cum[2, :b]
    return src, dest
