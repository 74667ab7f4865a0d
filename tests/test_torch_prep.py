"""Prep as hand-written CUDA (``leafcull.prep_cuda``, ``csrc/prep.cu``): a
model of the kernels' algorithm (int32 keys with the sign bit flipped, the
cell table of ``prep_cells``: one lower bound a cell and a scan of the
padding over 1,024 threads' runs; the per-slot lookup of ``prep_rows``: the
last cell whose padded start lies at or below the slot, the source ray,
dest from each sorted key's cell) against the torch operations it
replaces (``core.sort.plan_bucket_pad``, ``leafcull.prep_feats_plain``)
and the JAX package's ``plan_bucket_pad``, bit for bit; the dispatch,
which gives CPU tensors the torch operations; and the wrapper's guards.

The kernels themselves run only on the card; ``chip_smoke.py`` holds them
to the same torch operations there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401
from tracer.core.sort import plan_bucket_pad as j_plan
from tracer_torch import trace
from tracer_torch.core.sort import octahedral_codes, plan_bucket_pad
from tracer_torch.kernels import _lib
from tracer_torch.kernels import leafcull as tleaf

CELL_THREADS = 1024      # prep_cells' block
PARKED_SHARE = 0.988     # path_100k's rays parked at +x after bounce 0


def keys_of(d: torch.Tensor) -> torch.Tensor:
    """prep_keys: the octahedral code with its sign bit flipped, as int32
    (code ^ 2^31 read as signed is code - 2^31)."""
    return (octahedral_codes(d) - 2 ** 31).to(torch.int32)


def cells_model(sorted_keys: torch.Tensor, subpacket: int, cell_bits: int):
    """prep_cells: (pstart, pad_before, cap) per cell. Each cell's bound is
    the lower bound of its first code among the keys; thread t of the
    block owns the cells [t * per, (t + 1) * per), sums their padding,
    takes the exclusive scan of the threads' sums and runs through its
    cells from there."""
    b = sorted_keys.shape[0]
    ncells = 1 << cell_bits
    edges = (torch.arange(ncells, dtype=torch.int64) << (32 - cell_bits)) \
        - 2 ** 31
    bounds = torch.cat([torch.searchsorted(sorted_keys.long(), edges),
                        torch.tensor([b])])
    start, cnt = bounds[:-1], bounds[1:] - bounds[:-1]
    pad = (subpacket - cnt % subpacket) % subpacket
    per = -(-ncells // CELL_THREADS)
    own = torch.nn.functional.pad(pad, (0, CELL_THREADS * per - ncells)) \
        .reshape(CELL_THREADS, per)
    sums = own.sum(1)
    before = (torch.cumsum(sums, 0) - sums)[:, None] \
        + torch.cumsum(own, 1) - own
    pad_before = before.reshape(-1)[:ncells]
    return (start + pad_before, pad_before,
            start + torch.clamp(cnt - 1, min=0))


def slots_model(sorted_keys, cells, total: int, subpacket: int,
                cell_bits: int):
    """prep_rows: (src (total,) the sorted index each slot takes, dest
    (B,) each sorted ray's slot). Slots past Bp take slot Bp - 1's."""
    b = sorted_keys.shape[0]
    pstart, pad_before, cap = cells
    bp = b + (subpacket << cell_bits)
    q = torch.clamp(torch.arange(total), max=bp - 1)
    c = torch.searchsorted(pstart, q, right=True) - 1
    src = torch.clamp(torch.minimum(q - pad_before[c], cap[c]), 0, b - 1)
    cell = (sorted_keys.long() + 2 ** 31) >> (32 - cell_bits)
    return src, torch.arange(b) + pad_before[cell]


def prep_model(o, d, subpackets, subpacket, cell_bits, t_max=None):
    """prep_cuda's three launches and its sort, in torch operations."""
    b = o.shape[0]
    step = subpackets * subpacket
    total = -(-(b + (subpacket << cell_bits)) // step) * step
    sk, perm = torch.sort(keys_of(d), stable=True)
    cells = cells_model(sk, subpacket, cell_bits)
    src, dest_sorted = slots_model(sk, cells, total, subpacket, cell_bits)
    feats = tleaf._feature_rows(o, d, t_max)[perm[src]]
    dest = torch.empty_like(dest_sorted)
    dest[perm] = dest_sorted
    return feats.reshape(-1, subpackets, subpacket, tleaf.FEAT), dest


def rays(kind: str, b: int, seed: int):
    """(o, d) float32: ``uniform`` origin rays; ``narrow`` directions in a
    cone of a few degrees (most cells empty); ``parked`` every ray at
    +x from 1e18, as the renderer parks dead rays; ``parked_tail`` that
    for the last 98.8 %, off-origin live rays before them."""
    rng = np.random.default_rng(seed)
    o, d = tp.origin_rays_np(b, seed)
    if kind == "narrow":
        d = np.array([0.3, -0.5, 0.8]) + rng.normal(0, 0.02, (b, 3))
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    live = {"parked": 0, "parked_tail": b - int(b * PARKED_SHARE)}.get(kind,
                                                                       b)
    o = o + rng.uniform(-50, 50, (b, 3)).astype(np.float32)
    o[live:] = 1e18
    d[live:] = (1.0, 0.0, 0.0)
    return torch.as_tensor(o), torch.as_tensor(d)


# (rays, kind, subpackets, subpacket, cell_bits)
CASES = {
    "empty_cells": (300, "narrow", 4, 64, 9),
    "one_cell": (500, "parked", 4, 64, 8),
    "parked_tail": (3000, "parked_tail", 8, 64, 8),
    "b_below_sp": (37, "uniform", 4, 64, 8),
    "b_one": (1, "uniform", 8, 128, 9),
    # B and B + 16 * 64 both whole steps of 4 x 64.
    "exact_multiple": (6 * 4 * 64, "uniform", 4, 64, 4),
    "cell_bits_8": (2000, "uniform", 8, 128, 8),
    "cell_bits_9": (2000, "uniform", 8, 128, 9),
}
WITH_T_MAX = {"parked_tail", "b_below_sp", "cell_bits_9"}


@pytest.mark.parametrize("case", list(CASES))
def test_cell_table_and_slots_equal_plan_bucket_pad(case):
    """The model's src and dest equal the torch ``plan_bucket_pad``'s and
    the JAX package's on the same sorted codes."""
    b, kind, _, subpacket, cell_bits = CASES[case]
    _, d = rays(kind, b, seed=len(case))
    sk, _ = torch.sort(keys_of(d), stable=True)
    codes = sk.long() + 2 ** 31
    bp = b + (subpacket << cell_bits)
    src, dest = slots_model(sk, cells_model(sk, subpacket, cell_bits), bp,
                            subpacket, cell_bits)
    psrc, pdest = plan_bucket_pad(codes, subpacket, cell_bits=cell_bits)
    jsrc, jdest = j_plan(jnp.asarray(tp.np_(codes).astype(np.uint32)),
                         subpacket, cell_bits=cell_bits)
    assert torch.equal(src, psrc) and torch.equal(dest, pdest)
    np.testing.assert_array_equal(tp.np_(src), tp.np_(jsrc))
    np.testing.assert_array_equal(tp.np_(dest), tp.np_(jdest))
    if kind == "narrow":
        cnt = torch.bincount(codes >> (32 - cell_bits),
                             minlength=1 << cell_bits)
        assert int((cnt == 0).sum()) > (1 << cell_bits) // 2


@pytest.mark.parametrize("case", list(CASES))
def test_prep_model_equals_the_torch_operations(case):
    """The whole of prep_cuda's algorithm, the edge padding to the step
    included, gives prep_feats_plain's rows and dest bit for bit."""
    b, kind, S, SP, cell_bits = CASES[case]
    o, d = rays(kind, b, seed=len(case) + 1)
    t_max = (torch.linspace(1.0, 900.0, b) if case in WITH_T_MAX else None)
    feats, dest = prep_model(o, d, S, SP, cell_bits, t_max)
    pfeats, pdest = tleaf.prep_feats_plain(o, d, S, SP, cell_bits, t_max)
    assert feats.shape == pfeats.shape and feats.dtype == torch.float32
    assert torch.equal(feats.view(torch.int32), pfeats.view(torch.int32))
    assert torch.equal(dest, pdest)


@pytest.mark.parametrize("kind", ["uniform", "duplicates", "parked_tail"])
def test_int32_keys_sort_as_the_codes(kind):
    """Flipping the sign bit of the 32-bit code gives an int32 whose
    stable sort is the int64 codes' permutation, duplicates included."""
    b = 4096
    _, d = rays("parked_tail" if kind == "parked_tail" else "uniform", b, 9)
    if kind == "duplicates":
        d = d[torch.randint(0, 16, (b,),
                            generator=torch.Generator().manual_seed(3))]
    codes = octahedral_codes(d)
    sk, perm = torch.sort(keys_of(d), stable=True)
    sc, cperm = torch.sort(codes, stable=True)
    assert torch.equal(perm, cperm)
    assert torch.equal(sk.long() + 2 ** 31, sc)


def test_cpu_tensors_take_the_torch_operations(monkeypatch):
    """CPU tensors run the plain path: no launch is reached, the span
    counts no ``kernels``, and the rows are the same with the trace on and
    off."""
    o, d = rays("uniform", 700, seed=4)

    def no_launch(*a):
        raise AssertionError("prep on CPU tensors reached _lib.launch")
    monkeypatch.setattr(_lib, "launch", no_launch)
    launches = _lib.launches["prep_cuda"]
    off = tt.prep_feats_bucketed(o, d, tp.S, tp.SP, cell_bits=tp.CELL_BITS)
    trace.reset()
    with trace.enabled():
        on = tt.prep_feats_bucketed(o, d, tp.S, tp.SP,
                                    cell_bits=tp.CELL_BITS)
    (span,) = [s for r in trace.records() for s in r["spans"]
               if s["name"] == "tracer_torch.prep"]
    trace.reset()
    assert span["counters"].get("kernels", 0) == 0
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    assert _lib.launches["prep_cuda"] == launches


@pytest.mark.parametrize("bad", ["cpu", "t_max_length", "t_max_dtype",
                                 "cell_bits", "dtype"])
def test_prep_cuda_refuses(bad):
    o, d = rays("uniform", 64, seed=5)
    kw = {"t_max": {"t_max_length": torch.ones(65),
                    "t_max_dtype": torch.ones(64, dtype=torch.float64)}
          .get(bad)}
    cell_bits = 13 if bad == "cell_bits" else 8
    if bad == "dtype":
        d = d.double()
    match = {"cpu": "runs on CUDA tensors", "cell_bits": "cell_bits",
             "dtype": "float32"}.get(bad, "t_max")
    with pytest.raises(ValueError, match=match):
        tleaf.prep_cuda(o, d, 4, 64, cell_bits, **kw)
