"""Batch closest-hit queries: the reference's benchmark mode.

Each request is one batch of origin rays from a pool drawn in set-up and
cycled, so no batch repeats back to back. The window drives the port's
prep (``leafcull.prep_feats_bucketed`` and ``conecull.kernel_order_dest``)
and its closest hit: ``conecull.nearest_hit_hybrid_feats`` on single-chunk
tables, or ``tlas.nearest_hit_tlas_feats`` with
``tracer_torch.bench.large.budgets`` on routed ones. A query whose overflow
flag is set has failed. A request's work is its rays.

The check takes a sample of the window's queries and of their rays, both
drawn from the seed, and judges each ray's (t, sphere) in ray order against
the brute-force closest hit.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from benchmark import inputs
from benchmark.drivers import common
from benchmark.timing import sync
from benchmark.reference.sphere import closest_hit


def setup(cfg: dict, tr: dict, seed: int, device: torch.device):
    from tracer_torch.kernels.conecull import build_cone_tables
    st = SimpleNamespace(cfg=cfg, tr=tr, seed=seed, device=device)
    st.centers, st.radii, st.albedo = inputs.spheres(cfg, seed, device)
    st.tables = build_cone_tables(common.scene(st), common.bvh(st))
    st.pool = [inputs.directions(int(tr["rays"]), seed, 1 + k, device)
               for k in range(int(tr["pool"]))]
    st.origin = torch.tensor(tr["origin"], dtype=torch.float32,
                             device=device).expand(int(tr["rays"]), 3) \
        .contiguous()
    if tr["path"] == "routed":
        from tracer_torch.bench.large import budgets
        st.budget = budgets(int(cfg["spheres"]), st.tables.cull.num_chunks,
                            int(tr["rays"]))
    return st


def _rays(st, k: int):
    return st.origin, st.pool[k]


def _query(st, o, d, spans):
    from tracer_torch.kernels import conecull, leafcull, tlas
    tr = st.tr
    S, SP = int(tr["subpackets"]), int(tr["subpacket"])
    spans.mark("prep")
    feats, dest = leafcull.prep_feats_bucketed(o, d, S, SP,
                                               cell_bits=int(tr["cell_bits"]))
    dest = conecull.kernel_order_dest(dest, S, SP)
    spans.mark("nearest")
    if tr["path"] == "routed":
        mg, npairs, kc, pair_block = st.budget
        t, slot, overflow = tlas.nearest_hit_tlas_feats(
            feats, st.tables, mg, int(tr["max_candidates"]), npairs, kc,
            pair_block)
    else:
        t, slot, overflow = conecull.nearest_hit_hybrid_feats(
            feats, st.tables, int(tr["max_groups"]),
            int(tr["max_candidates"]))
    spans.close()
    return t, slot, dest, overflow


def warmup(st) -> None:
    for n in range(int(st.tr["warmup_requests"])):
        _query(st, *_rays(st, n % len(st.pool)), common.NO_SPANS)
    sync(st.device)


def request(st, spans):
    pool = len(st.pool)
    rays = int(st.tr["rays"])

    def run(n: int):
        k = n % pool
        t, slot, dest, overflow = _query(st, *_rays(st, k), spans)
        sync(st.device)
        spans.read()
        bad = bool(overflow)
        return (0 if bad else rays), bad, (k, t, slot, dest)
    return run


def release(st, kept):
    """Each kept query as (pool index, sampled ray ids, t, sphere id) in
    ray order; the tables are dropped."""
    s2s = st.tables.cull.slot_to_sphere.long()
    rng = inputs.numpy_rng(st.seed, 7)
    n_check = min(int(st.tr["check_rays"]), int(st.tr["rays"]))
    out = []
    for k, t, slot, dest in kept:
        rays = torch.as_tensor(
            rng.choice(int(st.tr["rays"]), n_check, replace=False),
            device=st.device)
        at = dest[rays]
        s = slot[at].long()
        sid = torch.where(s >= 0, s2s[torch.clamp(s, min=0)], -1)
        out.append((k, rays, t[at].float(), sid))
    del st.tables
    common.free(st.device)
    return out


def check(st, kept, control=None) -> dict:
    """id_mismatch_share: sampled rays whose sphere differs from brute
    force's (a hit against a miss included); t_rel_err_max: the largest
    |t - t_ref| / t_ref over rays that hit the same sphere."""
    mism, rays, t_err = 0, 0, 0.0
    for k, ids, t, sid in kept:
        o, d = _rays(st, k)
        o, d = o[ids], d[ids]
        t_ref, id_ref = closest_hit(o, d, st.centers, st.radii)
        if control is not None:
            t, sid = closest_hit(o, d, st.centers, st.radii,
                                 dtype=common.dtype(control))
        same = sid == id_ref
        mism += int((~same).sum())
        rays += ids.numel()
        hit = same & (id_ref >= 0)
        if bool(hit.any()):
            err = (t[hit] - t_ref[hit]).abs() / t_ref[hit]
            t_err = max(t_err, float(torch.nan_to_num(err, nan=torch.inf)
                                     .max()))
    return {"id_mismatch_share": mism / max(rays, 1),
            "t_rel_err_max": t_err, "checked_rays": rays}

