"""Octahedral ray sorting and cell bucket-padding for packet coherence.

PyTorch counterpart of ``tracer/core/sort.py``. The cull stages treat every ``subpacket``
consecutive rays as one frustum, so rays are sorted by a Morton code of the
octahedral direction map and padded at coarse code-cell boundaries, which
keeps every subpacket inside one narrow direction cell. The renderer's
wavefront compaction sorts by the coarser cube-Morton direction code.

The codes are uint32 in the reference; here they live in int64 masked to
32 bits, which sorts identically and keeps to ops torch covers for int64.
"""

from __future__ import annotations

import torch
from torch import Tensor

from tracer_torch import trace
from tracer_torch.core.types import Ray


def _part_bits(v: Tensor) -> Tensor:
    """Spread 8 bits of v over 24 bits (2 zero bits between each); int64."""
    v = v.to(torch.int64) & 0xFF
    v = (v | (v << 8)) & 0x00F00F
    v = (v | (v << 4)) & 0x0C30C3
    v = (v | (v << 2)) & 0x249249
    return v


def direction_morton_codes(d: Tensor, bits: int = 8) -> Tensor:
    """Morton code of unit directions, (B,) int64 in [0, 2^24): 8 bits per
    component of (d * 0.5 + 0.5) quantised."""
    top = 2 ** bits - 1
    q = torch.clamp((d * 0.5 + 0.5) * top, 0, top).to(torch.int64)
    return (_part_bits(q[:, 0]) | (_part_bits(q[:, 1]) << 1)
            | (_part_bits(q[:, 2]) << 2))


def sort_rays_by_direction(rays: Ray):
    """Sort a flat ray batch by direction Morton code (stable, as
    ``jnp.argsort``). Returns (sorted rays, inverse permutation): index a
    result with the inverse to restore the caller's order."""
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    perm = torch.argsort(direction_morton_codes(d), stable=True)
    inv = torch.argsort(perm, stable=True)
    return Ray(origin=o[perm], direction=d[perm]), inv


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
    # A copy from pageable host memory and a host int written into a
    # device tensor: each waits for the device.
    with trace.span("sync", "cell_bounds"):
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


def gather_rays(o: Tensor, d: Tensor, idx: Tensor):
    """(o[idx], d[idx]) through one gather of packed (B, 8) rows."""
    packed = torch.cat([o, d, torch.zeros_like(o[:, :2])], dim=1)[idx]
    return packed[:, 0:3], packed[:, 3:6]


def bucket_pad_sorted(o: Tensor, d: Tensor, codes: Tensor, subpacket: int,
                      cell_bits: int = 8):
    """Pad a code-sorted ray stream at the boundaries of 2^cell_bits
    code-prefix cells, so that no subpacket straddles two cells. o/d must be
    sorted by ``codes`` (ascending). Returns (o_padded, d_padded, dest):
    padding slots replicate the previous real ray, dest (B,) int64 maps each
    input ray to its slot; the padded length is B + 2^cell_bits * subpacket.
    """
    src, dest = plan_bucket_pad(codes, subpacket, cell_bits)
    op, dp = gather_rays(o, d, src)
    return op, dp, dest


def prep_rays_bucketed(rays: Ray, subpacket: int, cell_bits: int = 8):
    """Octahedral sort and cell bucket-pad in one gather: (padded Ray, dest)
    with dest (B,) int64 mapping each input ray to its padded slot."""
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    sc, perm = torch.sort(octahedral_codes(d), stable=True)
    src, dest_sorted = plan_bucket_pad(sc, subpacket, cell_bits)
    op, dp = gather_rays(o, d, perm[src])
    dest = torch.empty_like(dest_sorted)
    dest[perm] = dest_sorted
    return Ray(origin=op, direction=dp), dest


def sort_rays_octahedral(rays: Ray):
    """Sort a flat ray batch by octahedral Morton code (stable). Returns
    (sorted rays, inverse permutation), as :func:`sort_rays_by_direction`."""
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    perm = torch.argsort(octahedral_codes(d), stable=True)
    inv = torch.argsort(perm, stable=True)
    return Ray(origin=o[perm], direction=d[perm]), inv
