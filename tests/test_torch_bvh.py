"""PyTorch port vs the JAX package: BVH build (NumPy and native), the
FlatBVH invariants, and the cull and cone tables built from one BVH.

Integer arrays and box tables must be identical; the port's slot-major prim
table, in the JAX layout (``torch_parity.jax_prims``), must hold exactly
the JAX entries' values.
"""

import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tracer.bvh.builder import build_bvh as jax_build_bvh
from tracer.bvh.flat import padded_scene_arrays as j_padded
from tracer.kernels.conecull import build_cone_tables as j_cone_tables
from tracer_torch import _build
from tracer_torch.bvh import native

BVH_FIELDS = ("node_min", "node_max", "escape", "leaf_start", "prim_idx")


def _assert_same_bvh(got, want):
    assert got.leaf_size == want.leaf_size
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(tp.np_(getattr(got, f)),
                                      tp.np_(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("leaf_size,n", [(4, 300), (8, 500), (32, 900)])
def test_build_bvh_numpy_matches_jax(leaf_size, n):
    c, r, _ = tp.scene_np(n, seed=leaf_size)
    want = jax_build_bvh(c, r, leaf_size=leaf_size, backend="numpy")
    got = tt.build_bvh(c, r, leaf_size=leaf_size, backend="numpy",
                       device="cpu")
    _assert_same_bvh(got, want)
    tt.validate_bvh(got, c, r)


@pytest.mark.parametrize("leaf_size,n", [(8, 700), (32, 5000)])
def test_build_bvh_native_matches_jax(leaf_size, n):
    c, r, _ = tp.scene_np(n, seed=11, world=200.0)
    want = jax_build_bvh(c, r, leaf_size=leaf_size, backend="native")
    got = tt.build_bvh(torch.as_tensor(c), torch.as_tensor(r),
                       leaf_size=leaf_size, backend="native", device="cpu")
    _assert_same_bvh(got, want)
    tt.validate_bvh(got, c, r)
    assert got.node_min.dtype == torch.float32
    assert got.escape.dtype == torch.int32


def test_native_builder_raises_without_compiler(monkeypatch, tmp_path):
    c, r, _ = tp.scene_np(200)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", "no-such-compiler-xyz")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="no-such-compiler-xyz"):
        tt.build_bvh(c, r, leaf_size=8, backend="native", device="cpu")
    # "auto" takes the NumPy builder when the native one cannot be built.
    _assert_same_bvh(
        tt.build_bvh(c, r, leaf_size=8, backend="auto", device="cpu"),
        tt.build_bvh(c, r, leaf_size=8, backend="numpy", device="cpu"))
    with pytest.raises(ValueError):
        tt.build_bvh(c, r, backend="cuda", device="cpu")
    with pytest.raises(ValueError):
        tt.build_bvh(np.zeros((0, 3)), np.zeros(0))


def test_validate_bvh_catches_corruption():
    c, r, _ = tp.scene_np(300)
    bvh = tt.build_bvh(c, r, leaf_size=8, backend="numpy", device="cpu")
    tt.validate_bvh(bvh, c, r)
    bad = tt.FlatBVH(bvh.node_min, bvh.node_max, bvh.escape, bvh.leaf_start,
                     bvh.prim_idx.clone(), bvh.leaf_size)
    bad.prim_idx[0] = bad.prim_idx[1]            # a sphere listed twice
    with pytest.raises(AssertionError, match="partition"):
        tt.validate_bvh(bad, c, r)
    esc = tt.FlatBVH(bvh.node_min, bvh.node_max, torch.zeros_like(bvh.escape),
                     bvh.leaf_start, bvh.prim_idx, bvh.leaf_size)
    with pytest.raises(AssertionError, match="escape"):
        tt.validate_bvh(esc, c, r)


def test_padded_scene_arrays_match_jax():
    c, r, _ = tp.scene_np(10)
    jc, jr = j_padded(tp.to_jax(c), tp.to_jax(r))
    pc, pr = tt.padded_scene_arrays(torch.as_tensor(c), torch.as_tensor(r))
    np.testing.assert_array_equal(tp.np_(pc), tp.np_(jc))
    np.testing.assert_array_equal(tp.np_(pr), tp.np_(jr))


TABLE_CASES = {
    "ls8": dict(leaf_size=8, n=700, max_chunk_bytes=9 << 20),
    "ls32": dict(leaf_size=32, n=900, max_chunk_bytes=9 << 20),
    "ls8_chunked": dict(leaf_size=8, n=700, max_chunk_bytes=80 * 1024),
    "ls16_chunked": dict(leaf_size=16, n=3000, max_chunk_bytes=120 * 1024),
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_cull_and_cone_tables_match_jax(case):
    cfg = TABLE_CASES[case]
    c, r, a = tp.scene_np(cfg["n"], seed=5)
    jscene, tscene = tp.scenes(c, r, a)
    jb, tb = tp.bvhs(c, r, cfg["leaf_size"])
    jt = j_cone_tables(jscene, jb, max_chunk_bytes=cfg["max_chunk_bytes"])
    t = tt.build_cone_tables(tscene, tb, max_chunk_bytes=cfg["max_chunk_bytes"])
    jc, tc = jt.cull, t.cull
    if case.endswith("chunked"):
        assert tc.num_chunks > 1
    for f in ("leaf_size", "leaves_per_group", "leaves_per_chunk",
              "num_leaves", "num_real_leaves", "num_chunks", "num_groups"):
        assert getattr(tc, f) == getattr(jc, f), f
    for f in ("leaf_min", "leaf_max", "group_boxes", "group_min",
              "group_max", "slot_to_sphere"):
        np.testing.assert_array_equal(tp.np_(getattr(tc, f)),
                                      tp.np_(getattr(jc, f)), err_msg=f)
    np.testing.assert_array_equal(tp.np_(t.leaf_boxes), tp.np_(jt.leaf_boxes))
    assert t.r_max == jt.r_max

    prims = tp.np_(tp.jax_prims(tc.prims))
    want = tp.entries_to_prims(jc.entries, jc.leaf_size)
    assert prims.shape == want.shape
    real = tp.np_(tc.slot_to_sphere).reshape(prims.shape[:2]) >= 0
    np.testing.assert_array_equal(prims[real], want[real])
    assert (prims[~real] == np.float32([0.0, 0.0, 0.0, 1e30])).all()
    assert (tp.np_(tc.prims)[~real] == np.float32([0, 0, 0, -1e30])).all()
    assert real.any() and (~real).any()
