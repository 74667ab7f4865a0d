"""PyTorch port vs the JAX package: the BVH-against-brute-force sweep.

``complexity_fit`` must equal the JAX function on the same inputs (to
1e-12), and ``SweepResult`` must give the JAX record's JSON keys (plus
``device``) and the same ``benchmark_data.txt`` bytes. Each row path of
the sweep (``row_query``: the dense sweep, the single-chunk leaf walk, the
TLAS-routed walk over a host tree and over the device LBVH) runs on the
CPU through the plain versions of the kernels and is held against JAX
``nearest_hit_brute`` and ``nearest_hit_bvh`` on the same scene and rays:
sphere ids equal, t to the leaf-walk tolerance (``torch_parity``). The
sweep runs end to end on the CPU with every time positive (the
counterpart of ``tests/test_bench.py::test_run_sweep_smoke_cpu``, whose
chained timer can report a negative slope; the port times each call on
its own), and refuses to start without a card unless the CPU is asked
for. The committed card sweep (``results/h100/sweep.json``) is held to
the slope gates of ``tests/test_bench.py::test_committed_sweep_slopes``.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401
from tracer.bench import harness as jharness
from tracer.core.types import Ray as JRay
from tracer.intersect.brute import nearest_hit_brute as j_nearest_brute
from tracer.intersect.traverse import nearest_hit_bvh as j_nearest_bvh
from tracer_torch import cli
from tracer_torch.bench import harness
from tracer_torch.bench import large as tt_large
from tracer_torch.kernels import leafcull
from tracer_torch.kernels import tlas as tt_tlas
from tracer_torch.kernels.leafcull import check_slot_space

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD_SWEEP = os.path.join(ROOT, "results", "h100", "sweep.json")
CARD_PUBLISHED = os.path.join(ROOT, "results", "h100",
                              "sweep_published.json")
N = [1e3, 1e4, 1e5, 1e6]
RNG = np.random.default_rng(11)


@pytest.mark.parametrize("sizes,brute,bvh", [
    (N, [1e-3 * x / 1e3 for x in N], [1e-4 * np.log(x) for x in N]),
    (N, [float("nan"), 2e-2, 0.2, float("nan")], [3e-3, 0.0, 5e-3, 6e-3]),
    ([5000 * (i + 1) for i in range(10)], list(RNG.uniform(0.1, 2, 10)),
     list(RNG.uniform(1e-3, 1e-2, 10))),
    ([1000, 2000], [1.0, float("nan")], [float("nan"), 1.0]),
])
def test_complexity_fit_matches_jax(sizes, brute, bvh):
    got = harness.complexity_fit(sizes, brute, bvh)
    want = jharness.complexity_fit(sizes, brute, bvh)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0)
    if bvh[0] == 1e-4 * np.log(N[0]):      # tests/test_tools.py:92-99
        assert abs(got["brute_loglog_slope"] - 1.0) < 0.05
        assert got["bvh_loglog_slope"] < 0.25


def test_sweep_record_and_data_file_match_jax(tmp_path):
    lists = dict(sizes=[1000, 10000, 100000],
                 brute_s=[0.01, 0.1, float("nan")],
                 bvh_s=[0.002, 0.003, 0.004], build_ms=[1.0, 2.0, 3.0],
                 num_rays=131072, path="x", brute_nb=[131072, 16384, 0],
                 row_paths=["a", "b", "c"])
    got = harness.SweepResult(**lists, device="NVIDIA H100, 700 W").to_json()
    want = jharness.SweepResult(**lists).to_json()
    assert set(got) == set(want) | {"device", "row_stats"}
    assert json.dumps({k: got[k] for k in want}) == json.dumps(want)
    harness.SweepResult(**lists).save_data_txt(tmp_path / "port.txt")
    jharness.SweepResult(**lists).save_data_txt(tmp_path / "jax.txt")
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()


def _scene_rays(n, world, b=1024):
    c, r, a = tp.scene_np(n, seed=5, world=world)
    jscene, tscene = tp.scenes(c, r, a)
    o, d = harness.origin_rays(b, 0, "cpu")
    jrays = JRay(origin=jnp.asarray(tp.np_(o)),
                 direction=jnp.asarray(tp.np_(d)))
    return c, r, jscene, tscene, o, d, jrays


@pytest.fixture(scope="module")
def row_scene():
    """2000 spheres in a 60-unit world, 1024 of the sweep's rays, and
    JAX's brute-force and BVH closest hits for them (ids equal)."""
    c, r, jscene, tscene, o, d, jrays = _scene_rays(2000, 60.0)
    ref = j_nearest_brute(jrays, jscene)
    jb = tp.jax_build_bvh(c, r, leaf_size=8)
    via_bvh = jax.jit(j_nearest_bvh)(jrays, jscene, jb)
    np.testing.assert_array_equal(tp.np_(ref.index), tp.np_(via_bvh.index))
    return c, r, tscene, o, d, ref


@pytest.mark.parametrize("case,expect", [
    ("dense", "dense_brute_fast"), ("single_chunk", "hybrid_feats"),
    ("routed", "tlas_routed"), ("routed_lbvh", "tlas_routed")])
def test_row_query_matches_jax(row_scene, case, expect):
    c, r, tscene, o, d, ref = row_scene
    tables, dense_limit = None, 4000
    if case != "dense":
        dense_limit = 0
        bvh = (tt.build_bvh_device(tscene.centers, tscene.radii, 32)
               if case == "routed_lbvh" else
               tt.build_bvh(c, r, leaf_size=32, device="cpu"))
        tables = tt.build_cone_tables(
            tscene, bvh, max_chunk_bytes=(1 << 15) if "routed" in case
            else 9 << 20)
        assert (tables.cull.num_chunks > 1) == ("routed" in case)
    query, path, esc, budgets = harness.row_query(len(r), tscene, tables,
                                                  o, d, dense_limit)
    assert (path, esc) == (expect, 0)
    assert len(budgets or ()) == {"dense": 0, "single_chunk": 2}.get(case, 4)
    t, sid = query()
    np.testing.assert_array_equal(tp.np_(sid), tp.np_(ref.index))
    assert (tp.np_(sid) >= 0).sum() > 100
    tp.assert_ray_t_close(t, ref.t, o, d, sid, c, r)


def test_settle_doubles_every_budget_until_no_overflow():
    """Each doubling is logged; a query that still overflows at the caps
    raises rather than being timed at budgets that drop hits."""
    calls, logged = [], []

    def run(mg, mc):
        calls.append((mg, mc))
        return (None, torch.tensor(mg < 40 or mc < 500))
    with pytest.raises(RuntimeError, match="overflows at its caps"):
        harness._settle(run, (8, 119), (64, 400))
    assert calls == [(8, 119), (16, 238), (32, 400), (64, 400)]
    calls.clear()
    assert harness._settle(run, (8, 119), (64, 512), logged.append) == \
        ((64, 512), 3)
    assert calls == [(8, 119), (16, 238), (32, 476), (64, 512)]
    assert logged[-1] == "overflow at budgets (32, 476): doubled to (64, 512)"
    assert len(logged) == 3
    assert harness._settle(run, (64, 600), (64, 512)) == ((64, 512), 0)


@pytest.mark.parametrize("dense_limit,lbvh_from,paths", [
    (4000, 5_000_000, ["dense_brute_fast", "dense_brute_fast"]),
    (256, 1024, ["dense_brute_fast", "hybrid_feats_lbvh"]),
])
def test_run_sweep_on_the_cpu(dense_limit, lbvh_from, paths):
    res = harness.run_sweep(sizes=(256, 1024), num_rays=2048,
                            world_size=60.0, dense_limit=dense_limit,
                            device_build_min_n=lbvh_from, device="cpu",
                            log=lambda *a: None)
    assert res.row_paths == paths
    assert len(res.bvh_s) == 2 and all(v > 0 for v in res.bvh_s)
    assert all(v > 0 for v in res.brute_s + res.build_ms)
    assert res.brute_nb == [2048, 2048]
    j = res.to_json()
    assert "complexity" in j and len(j["speedup"]) == 2
    assert j["device"] == "cpu" and j["path"] == "plain"
    stats = j["row_stats"]
    assert [r["chunks"] for r in stats] == [0, int(dense_limit < 1024)]
    assert stats[0]["budgets"] is None and stats[0]["tables_ms"] == 0.0
    assert all(r["escalations"] == 0 and r["scene_ms"] > 0
               and np.isnan(r["peak_mib"]) for r in stats)


def test_run_sweep_keeps_the_timed_lbvh_and_frees_the_scene(monkeypatch):
    """Above ``brute_limit`` brute force is skipped (NaN) and the query is
    handed no scene, as in the JAX harness; the device LBVH is built twice
    (a warm-up, then the timed build) and the timed build's tree is the one
    the tables are built from."""
    builds, tables_from, scenes = [], [], {}
    real_build, real_tables = harness.build_bvh_device, \
        harness.build_cone_tables
    real_row_query = harness.row_query

    def build(*a):
        builds.append(real_build(*a))
        return builds[-1]

    def tables(scene, bvh):
        tables_from.append(bvh)
        return real_tables(scene, bvh)

    def row_query(n, scene, *a):
        scenes[n] = scene
        return real_row_query(n, scene, *a)
    monkeypatch.setattr(harness, "build_bvh_device", build)
    monkeypatch.setattr(harness, "build_cone_tables", tables)
    monkeypatch.setattr(harness, "row_query", row_query)
    res = harness.run_sweep(sizes=(512, 2048), num_rays=2048,
                            world_size=60.0, brute_limit=1024,
                            dense_limit=256, device_build_min_n=2048,
                            device="cpu", log=lambda *a: None)
    assert res.row_paths == ["hybrid_feats", "hybrid_feats_lbvh"]
    assert res.brute_nb == [2048, 0] and np.isnan(res.brute_s[1])
    assert scenes[512] is not None and scenes[2048] is None
    assert len(builds) == 2 and tables_from[1] is builds[1]
    assert all(v > 0 for v in res.bvh_s + res.build_ms)
    assert res.to_json()["complexity"].keys() == {"bvh_loglog_slope",
                                                  "bvh_logfit"}


def test_published_sizes_are_the_jax_sweeps():
    with open(os.path.join(ROOT, "results", "sweep.json")) as f:
        assert list(harness.PUBLISHED_SIZES) == json.load(f)["sizes"]
    assert harness.PUBLISHED_SIZES[-1] == 100_000_000


@pytest.mark.parametrize("chunks", [257, 1018, 1421])
@pytest.mark.parametrize("rays", [131072, 524288])
def test_budgets_above_256_chunks_are_the_jax_harness_tier(chunks, rays):
    """tracer/bench/harness.py:255-275 at C > 256 chunks: a per-chunk group
    budget of 32, npairs = min(C g, max(4096, 144 g)), kc = min(C, 512),
    pair blocks of 4096, g estimated from the ray count."""
    g = (rays + 256 * 128) // (8 * 128) + 1
    want = (32, min(chunks * g, max(4096, 144 * g)), min(chunks, 512), 4096)
    assert tt_large.budgets(100_000_000, chunks, rays) == want


@pytest.mark.parametrize("chunks,leaves,leaf_size,ok", [
    (1018, 3072, 32, True),             # the 100M tables
    (1023, 32768, 32, True),            # the last chunk count below 2^30
    (1024, 32768, 32, False),           # 2^30 slots exactly
    (1, 1 << 31, 1, False)])
def test_slot_space_guard(chunks, leaves, leaf_size, ok):
    """Padded slot counts at or above the no-slot sentinel 2^30 are refused
    before any walk, without allocating the table."""
    if ok:
        check_slot_space(chunks, leaves, leaf_size)
    else:
        with pytest.raises(ValueError, match="2\\^30"):
            check_slot_space(chunks, leaves, leaf_size)


def test_walk_wrappers_refuse_a_slot_space_of_2_30():
    """The leaf, any-hit and routed walks check the slot space of the
    table they are given: here 2^30 chunks of one one-prim leaf, a
    stride-0 view that allocates nothing."""
    C = 1 << 30
    feats = torch.zeros((1, 1, 64, 16))
    prims = torch.zeros((1, 1, 4)).expand(C, 1, 4)
    rows = torch.zeros((1, 1, 1, 8), dtype=torch.int32)
    pair = torch.zeros((1,), dtype=torch.int32)
    calls = [lambda: leafcull.leafcull_call(feats, rows.expand(C, 1, 1, 8),
                                            prims, 1, 1, 16),
             lambda: leafcull.anyhit_call(feats, rows.expand(C, 1, 1, 8),
                                          prims, 1, 1, 16),
             lambda: tt_tlas.routed_call(pair, pair, rows[0], feats, prims,
                                         1, 1, 16)]
    for call in calls:
        with pytest.raises(ValueError, match="2\\^30"):
            call()


def test_brute_force_matches_jax_and_caps_its_rays():
    c, r, jscene, tscene, o, d, jrays = _scene_rays(3000, 60.0, b=512)
    t, ids = harness.brute_t(o, d, tscene.centers, tscene.radii)
    ref = j_nearest_brute(jrays, jscene)
    np.testing.assert_array_equal(tp.np_(ids), tp.np_(ref.index))
    np.testing.assert_allclose(tp.np_(t), tp.np_(ref.t), rtol=1e-6)
    assert [harness.brute_rays(131072, n) for n in
            (1000, 10_000, 10 ** 9)] == [131072, 16384, 4096]


def test_sweep_and_cli_bench_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.run_sweep(sizes=(256,), num_rays=64)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["bench", "--sizes", "256", "--rays", "64"])


def test_cli_bench_writes_its_three_files(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["bench", "--device", "cpu", "--sizes", "256,1024",
                     "--rays", "2048", "--world-size", "60"]) == 0
    rec = json.loads((tmp_path / "benchmark_results.json").read_text())
    assert rec["sizes"] == [256, 1024] and rec["num_rays"] == 2048
    rows = (tmp_path / "benchmark_data.txt").read_text().splitlines()
    assert [int(x.split()[0]) for x in rows] == [256, 1024]
    png = (tmp_path / "benchmark_results.png").read_bytes()
    assert png.startswith(b"\x89PNG\r\n\x1a\n")
    out = capsys.readouterr().out
    assert '"brute_loglog_slope"' in out


def test_committed_card_sweep_slopes():
    """The card's sweep at the published decades holds the gates of
    tests/test_bench.py::test_committed_sweep_slopes: brute slope above
    0.55, the BVH's below 0.62 of it (0.5 of it up to 10M spheres), and the
    BVH faster than brute force at every size from 10k where both ran."""
    with open(CARD_SWEEP) as f:
        data = json.load(f)
    assert data["device"].startswith("NVIDIA H100")
    assert data["sizes"] == [1000, 10000, 100000, 1000000, 10000000]
    comp = data["complexity"]
    assert comp["brute_loglog_slope"] > 0.55, comp
    assert comp["bvh_loglog_slope"] < 0.62 * comp["brute_loglog_slope"], comp
    sizes = np.asarray(data["sizes"], np.float64)
    sub = sizes <= 10_000_000
    vv = np.asarray(data["bvh_s"], np.float64)[sub]
    slope_sub = np.polyfit(np.log(sizes[sub]), np.log(vv), 1)[0]
    assert slope_sub < 0.5 * comp["brute_loglog_slope"], slope_sub
    for n, b, v in zip(data["sizes"], data["brute_s"], data["bvh_s"]):
        if np.isfinite(b) and np.isfinite(v) and n >= 10_000:
            assert v < b, f"BVH slower than brute at n={n}"


def test_committed_card_published_sweep_gates():
    """The card's run of the JAX package's published sweep (``cli bench
    --sizes 1000,...,100000000 --rays 524288``) holds the gates of
    tests/test_bench.py::test_committed_sweep_slopes: brute slope above
    0.55, the BVH's below 0.62 of it over 1k-100M and below 0.5 of it over
    1k-10M, the BVH faster than brute force from 10k where both ran; its
    100M row is routed on the device LBVH past 256 chunks, with brute force
    skipped, as in results/sweep.json."""
    with open(CARD_PUBLISHED) as f:
        data = json.load(f)
    assert data["device"].startswith("NVIDIA H100")
    assert data["sizes"] == list(harness.PUBLISHED_SIZES)
    assert data["num_rays"] == 524288
    assert re.fullmatch(r"tlas_routed(_escalated\d+)?_lbvh",
                        data["row_paths"][-1])
    assert np.isnan(data["brute_s"][-1]) and data["brute_nb_timed"][-1] == 0
    assert data["row_stats"][-1]["chunks"] > 256
    comp = data["complexity"]
    assert comp["brute_loglog_slope"] > 0.55, comp
    assert comp["bvh_loglog_slope"] < 0.62 * comp["brute_loglog_slope"], comp
    sizes = np.asarray(data["sizes"], np.float64)
    sub = sizes <= 10_000_000
    vv = np.asarray(data["bvh_s"], np.float64)[sub]
    slope_sub = np.polyfit(np.log(sizes[sub]), np.log(vv), 1)[0]
    assert slope_sub < 0.5 * comp["brute_loglog_slope"], slope_sub
    for n, b, v in zip(data["sizes"], data["brute_s"], data["bvh_s"]):
        if np.isfinite(b) and np.isfinite(v) and n >= 10_000:
            assert v < b, f"BVH slower than brute at n={n}"
