"""PyTorch port vs the JAX package: the sanitizers (``tracer_torch.debug``).

The four cases of ``tests/test_debug.py`` on the port: the checked per-ray
walk passes on a clean scene (its t equal to the unchecked walk's and to
JAX's) and catches a NaN ray direction; the checked integrator passes on a
clean frame (the image of the unchecked render, bit for bit); and
``TRACER_DEBUG=1`` makes a NaN-producing operation raise in a fresh
process. Beyond them: the index check catches a corrupt tree
before it is read, level 2 catches Inf, level 0 turns the check off, and
a command run under ``TRACER_DEBUG=1`` renders a clean frame through the
leaf walk with compaction (parked rays included) and leaves the check off
when it returns.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401
from tracer import debug as jdebug
from tracer.core.types import Ray as JRay
from tracer_torch import cli
from tracer_torch.config import TracerConfig
from tracer_torch.debug import (DebugError, checked_nearest_hit,
                                checked_render, enable_debug)
from tracer_torch.integrator.wavefront import render
from tracer_torch.intersect.traverse import nearest_hit_bvh


@pytest.fixture(scope="module")
def small():
    """64 spheres in a 40-unit world (tests/test_debug.py's scene shape),
    a leaf-4 tree and 128 origin rays, for both packages."""
    c, r, a = tp.scene_np(64, seed=3, world=40.0)
    jscene, scene = tp.scenes(c, r, a)
    jb, bvh = tp.bvhs(c, r, 4)
    o, d = tp.origin_rays_np(128)
    return (jscene, jb, JRay(origin=jnp.asarray(o), direction=jnp.asarray(d)),
            scene, bvh, tt.Ray(origin=torch.as_tensor(o),
                               direction=torch.as_tensor(d)))


def test_checked_nearest_hit_clean(small):
    jscene, jb, jrays, scene, bvh, rays = small
    err, rec = checked_nearest_hit(rays, scene, bvh)
    err.throw()
    assert torch.equal(rec.t, nearest_hit_bvh(rays, scene, bvh).t)
    jerr, jrec = jax.jit(lambda r, s: jdebug.checked_nearest_hit(r, s, jb))(
        jrays, jscene)
    jerr.throw()
    np.testing.assert_array_equal(tp.np_(rec.index), tp.np_(jrec.index))
    c, r = scene.centers, scene.radii
    tp.assert_ray_t_close(rec.t, jrec.t, rays.origin, rays.direction,
                          rec.index, c, r)
    assert rec.hit.any()


def test_checked_nearest_hit_catches_nan(small):
    _, _, _, scene, bvh, rays = small
    d = rays.direction.clone()
    d[5, 0] = float("nan")
    err, out = checked_nearest_hit(tt.Ray(origin=rays.origin, direction=d),
                                   scene, bvh)
    assert out is None
    with pytest.raises(DebugError, match="nan"):
        err.throw()


def test_checked_nearest_hit_catches_a_corrupt_tree(small):
    _, _, _, scene, bvh, rays = small
    bad = tt.FlatBVH(node_min=bvh.node_min, node_max=bvh.node_max,
                     escape=bvh.escape, leaf_start=bvh.leaf_start,
                     prim_idx=bvh.prim_idx + 1000, leaf_size=bvh.leaf_size)
    err, _ = checked_nearest_hit(rays, scene, bad)
    with pytest.raises(DebugError, match="index out of range"):
        err.throw()


def test_checked_render_clean(small):
    scene = small[3]
    cfg = TracerConfig(width=16, height=12, max_depth=2)
    noise = np.random.default_rng(1).standard_normal((1, 12, 16, 3)) \
        .astype(np.float32)

    def nearest_for(s):
        return lambda r: tt.nearest_hit_brute(r, s)
    err, img = checked_render(scene, tt.Camera.default("cpu"), nearest_for,
                              cfg, torch.as_tensor(noise))
    err.throw()
    assert img.shape == (cfg.height, cfg.width, 3)
    assert bool(torch.isfinite(img).all())
    assert torch.equal(img, render(scene, tt.Camera.default("cpu"), None,
                                   nearest_for, cfg,
                                   noise=torch.as_tensor(noise)))


def test_tracer_debug_env_enables_nan_checking():
    """TRACER_DEBUG=1 makes a NaN-producing operation raise (a fresh
    process, as the command line reads the variable at its start)."""
    code = (
        "import os; os.environ['TRACER_DEBUG'] = '1'\n"
        "from tracer_torch.debug import maybe_enable_debug, DebugError\n"
        "assert maybe_enable_debug() == 1\n"
        "import torch\n"
        "try:\n"
        "    torch.log(torch.tensor(-1.0))\n"
        "except DebugError as e:\n"
        "    print('CAUGHT', e)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert "CAUGHT nan produced by aten.log" in out.stdout, \
        out.stdout + out.stderr


def test_levels_check_nan_then_inf_and_zero_turns_off():
    x = torch.tensor([0.0, 1.0])
    try:
        enable_debug(1)
        assert torch.isinf(1.0 / x).any()          # level 1: Inf passes
        with pytest.raises(DebugError, match="nan produced by aten.div"):
            x / x
        inf = 1.0 / x
        assert torch.isnan(inf - inf).any()        # NaN from Inf passes
        enable_debug(2)
        with pytest.raises(DebugError, match="inf produced by aten"):
            1.0 / x
    finally:
        enable_debug(0)
    assert torch.isnan(x / x).any()


def test_cli_render_under_tracer_debug(tmp_path, monkeypatch):
    monkeypatch.setenv("TRACER_DEBUG", "1")
    assert cli.main(["render", "--device", "cpu", "--width", "32",
                     "--height", "24", "--depth", "3", "--spheres", "300",
                     "--scene", "benchmark", "--world-size", "60",
                     "--compact", "--impl", "leafcull", "--out",
                     str(tmp_path / "d.png")]) == 0
    assert np.isfinite(np.load(tmp_path / "d.npy")).all()
    assert torch.isnan(torch.tensor(0.0) / 0.0)     # off after the command
