"""PyTorch port vs the JAX package: types, math, the oracle, scenes,
interop, ray sorting and prep, plus the port's import and dispatch guards.

Same seeded numpy inputs on both sides; integers must match exactly,
floats to the stated tolerance.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tracer.core import vecmath as jvec
from tracer.core.sort import (octahedral_codes as j_codes,
                              plan_bucket_pad as j_plan)
from tracer.core.types import Ray as JRay
from tracer.intersect import brute as jbrute
from tracer.intersect import sphere as jsphere
from tracer.kernels import conecull as jcone
from tracer.kernels import leafcull as jleaf
from tracer_torch.core import vecmath as tvec
from tracer_torch.core.sort import octahedral_codes, plan_bucket_pad
from tracer_torch.kernels import conecull as tcone
from tracer_torch.kernels import leafcull as tleaf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _vecs(n=64, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 3)).astype(np.float32)
    b = rng.normal(size=(n, 3)).astype(np.float32)
    a[0] = 0.0                                   # zero-guard case
    return a, b


# ---------------------------------------------------------------------------
# types and vector math
# ---------------------------------------------------------------------------

def test_ray_at_and_batch_shape():
    o, d = tp.origin_rays_np(12)
    o = o.reshape(3, 4, 3) + 1.0
    d = d.reshape(3, 4, 3)
    t = np.linspace(0.5, 3.0, 12, dtype=np.float32).reshape(3, 4)
    jr = JRay(origin=jnp.asarray(o), direction=jnp.asarray(d))
    tr = tt.Ray(origin=torch.as_tensor(o), direction=torch.as_tensor(d))
    assert tr.batch_shape == tuple(jr.batch_shape) == (3, 4)
    np.testing.assert_array_equal(tp.np_(tr.at(torch.as_tensor(t))),
                                  tp.np_(jr.at(jnp.asarray(t))))


def test_hit_record_miss():
    rec = tt.HitRecord.miss((2, 3))
    assert rec.t.shape == (2, 3) and torch.isinf(rec.t).all()
    assert (rec.index == -1).all() and not rec.hit.any()
    assert rec.point.shape == (2, 3, 3) and rec.index.dtype == torch.int32


@pytest.mark.parametrize("fn", ["dot", "length", "normalize", "cross",
                                "reflect", "refract"])
def test_vecmath_matches_jax(fn):
    a, b = _vecs()
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb_ = torch.as_tensor(a), torch.as_tensor(b)
    if fn in ("dot", "cross", "reflect"):
        got, want = getattr(tvec, fn)(ta, tb_), getattr(jvec, fn)(ja, jb)
    elif fn == "refract":
        got, want = tvec.refract(ta, tb_, 0.7), jvec.refract(ja, jb, 0.7)
    else:
        got, want = getattr(tvec, fn)(ta), getattr(jvec, fn)(ja)
    np.testing.assert_allclose(tp.np_(got), tp.np_(want), rtol=1e-6,
                               atol=1e-6)
    if fn == "normalize":
        assert (tp.np_(got)[0] == 0).all()


# ---------------------------------------------------------------------------
# intersection and the brute-force oracle
# ---------------------------------------------------------------------------

def _rays_and_spheres(b=256, n=40, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-5, 5, (b, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    c = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    r = rng.uniform(0.5, 6.0, n).astype(np.float32)
    return o, d, c, r


def test_ray_sphere_t_matches_jax():
    o, d, c, r = _rays_and_spheres()
    want = tp.np_(jsphere.ray_sphere_t(jnp.asarray(o)[:, None],
                                       jnp.asarray(d)[:, None],
                                       jnp.asarray(c)[None],
                                       jnp.asarray(r)[None]))
    got = tp.np_(tt.ray_sphere_t(torch.as_tensor(o)[:, None],
                                 torch.as_tensor(d)[:, None],
                                 torch.as_tensor(c)[None],
                                 torch.as_tensor(r)[None]))
    assert np.isfinite(want).any() and np.isinf(want).any()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)


def test_nearest_hit_brute_matches_jax():
    o, d, c, r = _rays_and_spheres()
    jscene, tscene = tp.scenes(c, r, np.zeros_like(c))
    want = jbrute.nearest_hit_brute(
        JRay(origin=jnp.asarray(o), direction=jnp.asarray(d)), jscene)
    got = tt.nearest_hit_brute(
        tt.Ray(origin=torch.as_tensor(o), direction=torch.as_tensor(d)),
        tscene)
    np.testing.assert_array_equal(tp.np_(got.index), tp.np_(want.index))
    np.testing.assert_array_equal(tp.np_(got.hit), tp.np_(want.hit))
    h = tp.np_(want.hit)
    assert h.any() and not h.all()
    for f in ("t", "point", "normal"):
        np.testing.assert_allclose(tp.np_(getattr(got, f))[h],
                                   tp.np_(getattr(want, f))[h],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("block", [64, 8192])
def test_brute_t_fast_matches_jax(block):
    o, d, c, r = _rays_and_spheres(b=300)
    jt, ji = jbrute.brute_t_fast(jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(c), jnp.asarray(r), block=block)
    t, i = tt.brute_t_fast(torch.as_tensor(o), torch.as_tensor(d),
                           torch.as_tensor(c), torch.as_tensor(r),
                           block=block)
    np.testing.assert_array_equal(tp.np_(i), tp.np_(ji))
    h = tp.np_(ji) >= 0
    # XLA fuses the quadratic (contracting mul+add) where torch rounds each
    # op; with off-origin rays disc cancels, so an ulp there moves t by up
    # to ~1e-5 relative. 2e-4 is the repo's kernel-vs-brute tolerance.
    np.testing.assert_allclose(tp.np_(t)[h], tp.np_(jt)[h], rtol=2e-4)
    assert np.isinf(tp.np_(t)[~h]).all()


# ---------------------------------------------------------------------------
# scenes and interop
# ---------------------------------------------------------------------------

def test_scene_factories_are_seeded_and_in_range():
    s1 = tt.benchmark_scene(torch.Generator().manual_seed(4), 500,
                            world_size=100.0)
    s2 = tt.benchmark_scene(torch.Generator().manual_seed(4), 500,
                            world_size=100.0)
    assert torch.equal(s1.centers, s2.centers)
    assert s1.centers.shape == (500, 3) and s1.num_spheres == 500
    assert s1.centers.abs().max() <= 50.0 and (s1.radii == 0.5).all()
    rs = tt.random_scene(torch.Generator().manual_seed(4), 300)
    lo = torch.tensor([-40.0, -20.0, -10.0])
    hi = torch.tensor([40.0, 20.0, 5.0])
    assert ((rs.centers >= lo) & (rs.centers <= hi)).all()
    assert ((rs.radii >= 0.5) & (rs.radii <= 5.0)).all()
    assert ((rs.albedo >= 0) & (rs.albedo <= 1)).all()
    fs = tt.fixed_scene([[0, 0, 0]], [1.0])
    assert fs.albedo.shape == (1, 3) and (fs.albedo == 0).all()


def test_interop_round_trips():
    c, r, a = tp.scene_np(200)
    s = tt.scene_from_numpy(c, r, a)
    for x, y in ((s.centers, c), (s.radii, r), (s.albedo, a)):
        assert x.dtype == torch.float32
        np.testing.assert_array_equal(tp.np_(x), y)
    assert (tt.scene_from_numpy(c, r).albedo == 0).all()
    jb, tb = tp.bvhs(c, r, 8)
    for f in ("node_min", "node_max", "escape", "leaf_start", "prim_idx"):
        np.testing.assert_array_equal(tp.np_(getattr(tb, f)),
                                      tp.np_(getattr(jb, f)))
    assert tb.leaf_size == jb.leaf_size and tb.num_nodes == jb.num_nodes
    assert tb.escape.dtype == tb.prim_idx.dtype == torch.int32


# ---------------------------------------------------------------------------
# sorting, bucketing and features
# ---------------------------------------------------------------------------

def _dirs(kind, b=2048, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        _, d = tp.origin_rays_np(b, seed)
    elif kind == "axes":
        d = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1], [1, 1, -1], [-1, -1, -1],
                      [0.5, -0.5, 0], [-0.3, 0.7, -0.01]], np.float32)
    else:                                        # many exact duplicates
        base = rng.normal(size=(16, 3)).astype(np.float32)
        d = base[rng.integers(0, 16, b)]
    return d


@pytest.mark.parametrize("kind", ["uniform", "axes", "duplicates"])
def test_octahedral_codes_and_sort_match_jax(kind):
    d = _dirs(kind)
    want = tp.np_(j_codes(jnp.asarray(d))).astype(np.int64)
    got = octahedral_codes(torch.as_tensor(d))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(tp.np_(got), want)
    # jax.lax.sort is stable; torch.sort(stable=True) must give the same
    # permutation, duplicates included.
    iota = jnp.arange(d.shape[0], dtype=jnp.int32)
    _, jperm = jax.lax.sort((j_codes(jnp.asarray(d)), iota), num_keys=1)
    _, perm = torch.sort(got, stable=True)
    np.testing.assert_array_equal(tp.np_(perm), tp.np_(jperm))


@pytest.mark.parametrize("b,subpacket,cell_bits",
                         [(2048, 64, 4), (1000, 128, 9), (300, 64, 8)])
def test_plan_bucket_pad_matches_jax(b, subpacket, cell_bits):
    codes = np.sort(tp.np_(j_codes(jnp.asarray(_dirs("uniform", b)))))
    jsrc, jdest = j_plan(jnp.asarray(codes), subpacket, cell_bits=cell_bits)
    src, dest = plan_bucket_pad(torch.as_tensor(codes.astype(np.int64)),
                                subpacket, cell_bits=cell_bits)
    np.testing.assert_array_equal(tp.np_(src), tp.np_(jsrc))
    np.testing.assert_array_equal(tp.np_(dest), tp.np_(jdest))


@pytest.mark.parametrize("with_t_max", [False, True])
def test_prep_feats_bucketed_matches_jax(with_t_max):
    rng = np.random.default_rng(2)
    o = rng.uniform(-3, 3, (1500, 3)).astype(np.float32)
    _, d = tp.origin_rays_np(1500, seed=2)
    tm = rng.uniform(1, 50, 1500).astype(np.float32) if with_t_max else None
    jf, jd = jleaf.prep_feats_bucketed(
        jnp.asarray(o), jnp.asarray(d), tp.S, tp.SP, cell_bits=tp.CELL_BITS,
        t_max=None if tm is None else jnp.asarray(tm))
    f, dest = tt.prep_feats_bucketed(
        torch.as_tensor(o), torch.as_tensor(d), tp.S, tp.SP,
        cell_bits=tp.CELL_BITS, t_max=None if tm is None
        else torch.as_tensor(tm))
    np.testing.assert_array_equal(tp.np_(dest), tp.np_(jd))
    assert tuple(f.shape) == tuple(jf.shape) and f.dtype == torch.float32
    np.testing.assert_allclose(tp.np_(f), tp.np_(jf), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        tp.np_(tcone.kernel_order_dest(dest, tp.S, tp.SP)),
        tp.np_(jcone.kernel_order_dest(jd, tp.S, tp.SP)))


def test_pack_ray_features_matches_jax():
    rng = np.random.default_rng(5)
    o = rng.uniform(-3, 3, (700, 3)).astype(np.float32)
    d = rng.normal(size=(700, 3)).astype(np.float32)
    jf, jg, jpad = jleaf.pack_ray_features(jnp.asarray(o), jnp.asarray(d),
                                           tp.S, tp.SP)
    f, g, pad = tt.pack_ray_features(torch.as_tensor(o), torch.as_tensor(d),
                                     tp.S, tp.SP)
    assert (g, pad) == (jg, jpad)
    np.testing.assert_allclose(tp.np_(f), tp.np_(jf), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# guards: no JAX in the port, plain versions on the CPU, no silent fallback
# ---------------------------------------------------------------------------

SLICE_MODULES = [
    "tracer_torch", "tracer_torch.core.types", "tracer_torch.core.vecmath",
    "tracer_torch.core.sort", "tracer_torch.intersect.sphere",
    "tracer_torch.intersect.brute", "tracer_torch.scene.scene",
    "tracer_torch.bvh.flat", "tracer_torch.bvh.builder",
    "tracer_torch.bvh.native", "tracer_torch.interop",
    "tracer_torch.kernels._lib", "tracer_torch.kernels.leafcull",
    "tracer_torch.kernels.conecull", "tracer_torch.bench.timing",
    "tracer_torch.bench.headline", "tracer_torch.bench.profile",
    "tracer_torch.bench.__main__",
]


def test_port_never_imports_jax():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'tracer.'))\n"
            "             or m in ('tracer', 'jaxlib', 'flax'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cpu_wrappers_run_plain_and_leave_counters_at_zero():
    tleaf.leafcull_cuda.launches = 0
    tcone.compact_cuda.launches = 0
    rng = np.random.default_rng(0)
    ids = np.sort(rng.integers(0, 500, (16, 256)), axis=1).astype(np.int32)
    ids[rng.random((16, 256)) < 0.5] = 1000
    ids = torch.as_tensor(ids)
    got = tt.compact_ascending_rows(ids, 1000, 64)
    want = tcone.compact_ascending_rows_plain(ids, 1000, 64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    c, r, a = tp.scene_np(300)
    _, tscene = tp.scenes(c, r, a)
    tables = tt.build_cone_tables(tscene, tt.build_bvh(c, r, leaf_size=8))
    o, d = tp.origin_rays_np(512)
    feats, _ = tt.prep_feats_bucketed(torch.as_tensor(o), torch.as_tensor(d),
                                      tp.S, tp.SP, cell_bits=tp.CELL_BITS)
    rows, cones, _ = tt.cone_candidates(feats, tables, 64, 119)
    assert cones is None
    cull = tables.cull
    rows = rows.reshape(cull.num_chunks, feats.shape[0], tp.S, -1)
    args = (feats, rows, cull.prims, cull.leaf_size, cull.leaves_per_chunk,
            cull.leaves_per_group)
    t, s = tt.leafcull_call(*args)
    tp_, sp_ = tleaf.leafcull_plain(*args)
    assert torch.equal(s, sp_[0]) and torch.equal(t, tp_[0])
    assert tleaf.leafcull_cuda.launches == 0
    assert tcone.compact_cuda.launches == 0


def test_wrappers_refuse_tensors_off_cpu_and_cuda():
    ids = torch.zeros((8, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tt.compact_ascending_rows(ids, 5, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tcone.compact_cuda(torch.zeros((8, 128), dtype=torch.int32), 5, 16)
    feats = torch.zeros((1, 1, 64, 16), device="meta")
    cand = torch.zeros((1, 1, 1, 128), dtype=torch.int32, device="meta")
    prims = torch.zeros((1, 32, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tt.leafcull_call(feats, cand, prims, 8, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tleaf.leafcull_cuda(torch.zeros_like(feats, device="cpu"),
                            torch.zeros_like(cand, device="cpu"),
                            torch.zeros_like(prims, device="cpu"), 8, 4, 16)
    assert tleaf.leafcull_cuda.launches == 0


def test_device_timing_and_bench_refuse_without_cuda(monkeypatch):
    from tracer_torch.bench import headline
    from tracer_torch.bench.timing import time_cuda
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        time_cuda(lambda: None)
    assert headline.main() == 1
