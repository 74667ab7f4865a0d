"""PyTorch port vs the JAX package: types, math, the oracle, scenes,
interop, ray sorting and prep, plus the port's import, dispatch and device
guards.

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
from tracer.core.sort import (bucket_pad_sorted as j_bucket_pad,
                              gather_rays as j_gather,
                              octahedral_codes as j_codes,
                              plan_bucket_pad as j_plan,
                              prep_rays_bucketed as j_prep_rays,
                              sort_rays_octahedral as j_sort_oct)
from tracer.core.types import Ray as JRay
from tracer.intersect import brute as jbrute
from tracer.intersect import sphere as jsphere
from tracer.kernels import conecull as jcone
from tracer.kernels import leafcull as jleaf
from tracer_torch.core import sort as tsort
from tracer_torch.core import vecmath as tvec
from tracer_torch.core.sort import octahedral_codes, plan_bucket_pad
from tracer_torch.kernels import _lib
from tracer_torch.kernels import conecull as tcone
from tracer_torch.kernels import leafcull as tleaf
from tracer_torch.kernels import tlas as ttlas

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
                            world_size=100.0, device="cpu")
    s2 = tt.benchmark_scene(torch.Generator().manual_seed(4), 500,
                            world_size=100.0, device="cpu")
    assert torch.equal(s1.centers, s2.centers)
    assert s1.centers.shape == (500, 3) and s1.num_spheres == 500
    assert s1.centers.abs().max() <= 50.0 and (s1.radii == 0.5).all()
    rs = tt.random_scene(torch.Generator().manual_seed(4), 300, device="cpu")
    lo = torch.tensor([-40.0, -20.0, -10.0])
    hi = torch.tensor([40.0, 20.0, 5.0])
    assert ((rs.centers >= lo) & (rs.centers <= hi)).all()
    assert ((rs.radii >= 0.5) & (rs.radii <= 5.0)).all()
    assert ((rs.albedo >= 0) & (rs.albedo <= 1)).all()
    fs = tt.fixed_scene([[0, 0, 0]], [1.0], device="cpu")
    assert fs.albedo.shape == (1, 3) and (fs.albedo == 0).all()


def test_interop_round_trips():
    c, r, a = tp.scene_np(200)
    s = tt.scene_from_numpy(c, r, a, device="cpu")
    for x, y in ((s.centers, c), (s.radii, r), (s.albedo, a)):
        assert x.dtype == torch.float32
        np.testing.assert_array_equal(tp.np_(x), y)
    assert (tt.scene_from_numpy(c, r, device="cpu").albedo == 0).all()
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
    np.testing.assert_allclose(tp.np_(tp.jax_feats(f)), tp.np_(jf),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        tp.np_(tcone.kernel_order_dest(dest, tp.S, tp.SP)),
        tp.np_(jcone.kernel_order_dest(jd, tp.S, tp.SP)))


def _prep_rays(b=1500, seed=6):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (b, 3)).astype(np.float32)
    d = np.concatenate([tp.origin_rays_np(b - 200, seed=seed)[1],
                        _dirs("duplicates", 200)]).astype(np.float32)
    return o, d


@pytest.mark.parametrize("subpacket,cell_bits", [(64, 4), (128, 9)])
def test_prep_rays_bucketed_matches_jax(subpacket, cell_bits):
    """Octahedral sort + cell bucket-pad in one gather: padded rays and
    dest exactly (duplicate directions included, so the sort must be
    stable)."""
    o, d = _prep_rays()
    jr, jdest = j_prep_rays(JRay(origin=jnp.asarray(o),
                                 direction=jnp.asarray(d)), subpacket,
                            cell_bits=cell_bits)
    r, dest = tt.prep_rays_bucketed(tt.Ray(origin=torch.as_tensor(o),
                                           direction=torch.as_tensor(d)),
                                    subpacket, cell_bits=cell_bits)
    np.testing.assert_array_equal(tp.np_(r.origin), tp.np_(jr.origin))
    np.testing.assert_array_equal(tp.np_(r.direction), tp.np_(jr.direction))
    np.testing.assert_array_equal(tp.np_(dest), tp.np_(jdest))
    assert r.origin.shape[0] == o.shape[0] + (1 << cell_bits) * subpacket


def test_bucket_pad_sorted_and_gather_rays_match_jax():
    o, d = _prep_rays(seed=7)
    codes = tp.np_(j_codes(jnp.asarray(d)))
    order = np.argsort(codes, kind="stable")
    o, d, codes = o[order], d[order], codes[order]
    jo, jd, jdest = j_bucket_pad(jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(codes), 64, cell_bits=4)
    to, td, dest = tsort.bucket_pad_sorted(
        torch.as_tensor(o), torch.as_tensor(d),
        torch.as_tensor(codes.astype(np.int64)), 64, cell_bits=4)
    for got, want in ((to, jo), (td, jd), (dest, jdest)):
        np.testing.assert_array_equal(tp.np_(got), tp.np_(want))
    idx = np.random.default_rng(8).integers(0, o.shape[0], 999)
    jg = j_gather(jnp.asarray(o), jnp.asarray(d), jnp.asarray(idx))
    tg = tsort.gather_rays(torch.as_tensor(o), torch.as_tensor(d),
                           torch.as_tensor(idx))
    for got, want in zip(tg, jg):
        np.testing.assert_array_equal(tp.np_(got), tp.np_(want))


def test_sort_rays_octahedral_matches_jax():
    o, d = _prep_rays(seed=9)
    jr, jinv = j_sort_oct(JRay(origin=jnp.asarray(o),
                               direction=jnp.asarray(d)))
    r, inv = tt.sort_rays_octahedral(tt.Ray(origin=torch.as_tensor(o),
                                            direction=torch.as_tensor(d)))
    np.testing.assert_array_equal(tp.np_(r.origin), tp.np_(jr.origin))
    np.testing.assert_array_equal(tp.np_(r.direction), tp.np_(jr.direction))
    np.testing.assert_array_equal(tp.np_(inv), tp.np_(jinv))
    np.testing.assert_array_equal(tp.np_(r.direction[inv]), d)


def test_pack_ray_features_matches_jax():
    rng = np.random.default_rng(5)
    o = rng.uniform(-3, 3, (700, 3)).astype(np.float32)
    d = rng.normal(size=(700, 3)).astype(np.float32)
    jf, jg, jpad = jleaf.pack_ray_features(jnp.asarray(o), jnp.asarray(d),
                                           tp.S, tp.SP)
    f, g, pad = tt.pack_ray_features(torch.as_tensor(o), torch.as_tensor(d),
                                     tp.S, tp.SP)
    assert (g, pad) == (jg, jpad)
    # The port's rows hold o where JAX's hold -2o, o.d and |o|^2.
    np.testing.assert_array_equal(tp.np_(f[..., 3:6]),
                                  tp.np_(jf[..., 3:6]) * -0.5)
    np.testing.assert_allclose(tp.np_(tp.jax_feats(f)), tp.np_(jf),
                               rtol=1e-6, atol=0)


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
    "tracer_torch.bench.__main__", "tracer_torch.core.device",
    "tracer_torch.bvh.device", "tracer_torch.kernels.tlas",
    "tracer_torch.bench.large", "tracer_torch.config",
    "tracer_torch.core.sampling", "tracer_torch.scene.camera",
    "tracer_torch.intersect.aabb", "tracer_torch.intersect.traverse",
    "tracer_torch.intersect.cull", "tracer_torch.kernels.traverse",
    "tracer_torch.kernels.tilecull", "tracer_torch.integrator.wavefront",
    "tracer_torch.cli", "tracer_torch.bench.render",
    "tracer_torch.kernels.cull", "tracer_torch.bench.headtohead",
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


def _port_sources():
    """Every source file of the port, chip_smoke.py, and the rank module
    that the distributed tests spawn (it must import no JAX either)."""
    root = os.path.join(REPO, "tracer_torch")
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "torch_dist_ranks.py")]
    for dirpath, _, names in os.walk(root):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh", ".cpp", ".h"))]
    return sorted(files)


def test_port_stands_alone():
    """No file of the port (nor chip_smoke.py) imports jax or the JAX
    package, or names a path under tracer/: a string that is "tracer" (a
    path part) or starts with "tracer/" and is not a "file.py:line"
    citation, or an #include of such a path. Docstrings and comments may
    cite the reference."""
    import ast
    import re
    cite = re.compile(r"^tracer/[\w/]+\.py:\d+$")
    bad = []
    for path in _port_sources():
        rel = os.path.relpath(path, REPO)
        text = open(path).read()
        if not path.endswith(".py"):
            for line in text.splitlines():
                if re.match(r'\s*#\s*include\s*["<](\.\./)*tracer/', line):
                    bad.append((rel, line.strip()))
            continue
        tree = ast.parse(text)
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef,
                                  ast.ClassDef, ast.AsyncFunctionDef))
                and n.body and isinstance(n.body[0], ast.Expr)
                and isinstance(n.body[0].value, ast.Constant)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                mods = []
            for m in mods:
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "tracer"):
                    bad.append((rel, f"import {m}"))
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", getattr(node.func, "attr", "")) in (
                        "import_module", "__import__"):
                bad.append((rel, "dynamic import"))
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and id(node) not in docs:
                v = node.value
                if v == "tracer" or (v.startswith("tracer/")
                                     and not cite.match(v)):
                    bad.append((rel, repr(v)))
    assert not bad, bad
    # The guard sees what it guards against.
    assert any(p.endswith("bvh_builder.cpp") for p in _port_sources())


def test_cpu_wrappers_run_plain_and_leave_counters_at_zero():
    _lib.launches.clear()
    rng = np.random.default_rng(0)
    ids = np.sort(rng.integers(0, 500, (16, 256)), axis=1).astype(np.int32)
    ids[rng.random((16, 256)) < 0.5] = 1000
    ids = torch.as_tensor(ids)
    got = tt.compact_ascending_rows(ids, 1000, 64)
    want = tcone.compact_ascending_rows_plain(ids, 1000, 64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    c, r, a = tp.scene_np(300)
    _, tscene = tp.scenes(c, r, a)
    tables = tt.build_cone_tables(tscene, tt.build_bvh(c, r, leaf_size=8,
                                                      device="cpu"))
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
    assert torch.equal(tt.anyhit_call(*args), tleaf.anyhit_plain(*args))

    G = feats.shape[0]
    pc = torch.zeros(G, dtype=torch.int32)
    pg = torch.arange(G, dtype=torch.int32)
    rargs = (pc, pg, rows[0], feats, cull.prims, cull.leaf_size,
             cull.leaves_per_chunk, cull.leaves_per_group)
    tr, sr = tt.routed_call(*rargs)
    trp, srp = ttlas.routed_plain(*rargs)
    assert torch.equal(sr, srp) and torch.equal(tr, trp)
    # One chunk, every packet routed: the routed walk is the leaf walk.
    assert torch.equal(sr, s) and torch.equal(tr, t)
    t2, s2, _ = tt.nearest_hit_tlas_feats(feats, tables)
    assert torch.equal(s2, tt.nearest_hit_hybrid_feats(feats, tables)[1])
    assert not _lib.launches

    # The packet and tile walks: CPU tensors take the plain versions.
    from tracer_torch.intersect.cull import build_leaf_table
    from tracer_torch.kernels import tilecull as ttile
    from tracer_torch.kernels import traverse as ttrav
    bvh = tt.build_bvh(c, r, leaf_size=16, device="cpu")
    packed = ttrav.pack_bvh(tscene, bvh)
    prays, _, _ = ttrav.pack_rays(torch.as_tensor(o), torch.as_tensor(d))
    got = ttrav.traverse_call(prays, packed)
    want = ttrav.traverse_plain(prays, packed)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    table = build_leaf_table(bvh)
    tf, _, _ = ttile.pack_ray_features(torch.as_tensor(o),
                                       torch.as_tensor(d), 2)
    cand, _ = ttile.subpacket_candidates(torch.as_tensor(o),
                                         torch.as_tensor(d), table, 64, 2)
    prims = ttile.pack_prim_tiles(packed)
    got = ttile.tilecull_call(tf, cand, prims)
    want = ttile.tilecull_plain(tf, cand, prims)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert not _lib.launches


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
    with pytest.raises(ValueError, match="CUDA"):
        tt.anyhit_call(feats, cand, prims, 8, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tleaf.anyhit_cuda(torch.zeros_like(feats, device="cpu"),
                          torch.zeros_like(cand, device="cpu"),
                          torch.zeros_like(prims, device="cpu"), 8, 4, 16)
    pair = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tt.routed_call(pair, pair, cand[0], feats, prims, 8, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ttlas.routed_cuda(*(torch.zeros_like(x, device="cpu") for x in (
            pair, pair, cand[0], feats, prims)), 8, 4, 16)
    assert not _lib.launches

    from tracer_torch.kernels import tilecull as ttile
    from tracer_torch.kernels import traverse as ttrav
    c, r, a = tp.scene_np(40)
    _, tscene = tp.scenes(c, r, a)
    packed = ttrav.pack_bvh(tscene, tt.build_bvh(c, r, leaf_size=8,
                                                 device="cpu"))
    rays = torch.zeros((1, ttrav.PACKET, 8))
    meta = ttrav.PackedBVH(*(x.to("meta") for x in (
        packed.nodes, packed.links, packed.prims, packed.prim_idx)),
        packed.num_nodes, packed.leaf_size)
    with pytest.raises(ValueError, match="CUDA"):
        ttrav.traverse_call(rays.to("meta"), meta)
    with pytest.raises(ValueError, match="CUDA"):
        ttrav.traverse_cuda(rays, packed)
    tfeats = torch.zeros((1, 1, 128, 16))
    tcand = torch.zeros((1, 1, 128), dtype=torch.int32)
    tprims = torch.zeros((2, 128, 4))
    with pytest.raises(ValueError, match="CUDA"):
        ttile.tilecull_call(tfeats.to("meta"), tcand.to("meta"),
                            tprims.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        ttile.tilecull_cuda(tfeats, tcand, tprims)
    assert not _lib.launches


def test_device_timing_and_bench_refuse_without_cuda(monkeypatch):
    from tracer_torch.bench import headline, headtohead, large, render
    from tracer_torch.bench.timing import time_cuda
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        time_cuda(lambda: None)
    assert headline.main() == 1
    assert large.main() == 1
    assert render.main() == 1
    assert headtohead.main([]) == 1


def test_entry_points_build_on_cuda_unless_asked(monkeypatch):
    """With no device given, scenes, trees and interop tensors go to the
    CUDA device; without CUDA they refuse rather than build on the CPU."""
    c, r, a = tp.scene_np(40)
    jb = tp.bvhs(c, r, 4)[0]
    bvh_arrays = [tp.np_(getattr(jb, f)) for f in (
        "node_min", "node_max", "escape", "leaf_start", "prim_idx")]
    calls = {
        "fixed_scene": lambda **k: tt.fixed_scene(c, r, a, **k),
        "random_scene": lambda **k: tt.random_scene(
            torch.Generator().manual_seed(0), 10, **k),
        "benchmark_scene": lambda **k: tt.benchmark_scene(
            torch.Generator().manual_seed(0), 10, **k),
        "build_bvh": lambda **k: tt.build_bvh(c, r, leaf_size=4, **k),
        "scene_from_numpy": lambda **k: tt.scene_from_numpy(c, r, a, **k),
        "flat_bvh_from_numpy": lambda **k: tt.flat_bvh_from_numpy(
            *bvh_arrays, 4, **k),
    }
    for name, call in calls.items():
        out = call(device="cpu")
        first = out.centers if hasattr(out, "centers") else out.node_min
        assert first.device.type == "cpu", name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
