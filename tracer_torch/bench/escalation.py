"""Which subpackets make a path frame's closest-hit calls escalate.

Run ``python -m tracer_torch.bench.escalation [--frames N]`` on a CUDA
machine. It renders N path frames of the render slice (100k spheres of
the benchmark distribution in the 1000-unit world, 800x600, depth 5,
compaction, ``--impl auto``, leaf 16) from (0, 4, 50) at yaw -pi, the
camera flying 1 unit a frame, through ``tracer_torch.cli``'s own code
path. For each checked closest-hit call it prints one JSON line: the
frame and bounce, the escalations, the launches of prep, phase A and the
leaf walk in the call (``_lib.launches``), and, for the first try of a
call that escalates, the subpackets whose bounds meet more groups than
the group prefix keeps (K0), the rule by which phase A overflows on these
tables, split into those that hold only live rays, only rays parked at
1e18 by compaction, or both, and the slots of live rays they hold (prep's
padded stream). The last line is one JSON object summing those. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from collections import Counter

import torch

from tracer_torch import cli
from tracer_torch.kernels import _lib, conecull, leafcull

WALKS = ("prep_cuda", "phase_a_cuda", "leafcull_cuda")
PARKED = 1.0e17     # origins past this are compaction's parked rays (1e18)


def argv(frames: int) -> list[str]:
    """The CLI arguments of the frames."""
    return ["render", "--scene", "benchmark", "--spheres", "100000",
            "--world-size", "1000", "--width", "800", "--height", "600",
            "--depth", "5", "--compact", "--impl", "auto", "--leaf-size",
            "16", "--camera-pos", "0,4,50", "--yaw", str(-math.pi),
            "--fly-speed", "1", "--frames", str(frames)]


def group_totals(feats, cull) -> torch.Tensor:
    """(P,) groups each subpacket's bounds meet: phase A's gtotal."""
    o_lo, o_hi, d_lo, d_hi = conecull.bounds_from_feats(feats)
    gm, gM = cull.group_min, cull.group_max
    hit = conecull._slab_hit_cols(o_lo, o_hi, d_lo, d_hi,
                                  tuple(gm[None, :, a] for a in range(3)),
                                  tuple(gM[None, :, a] for a in range(3)))
    gids = torch.arange(cull.num_groups, device=feats.device)
    real = gids * cull.leaves_per_group < cull.num_real_leaves
    return (hit & real[None, :]).sum(dim=1)


def first_try(feats, tables, max_groups: int, max_candidates: int) -> dict:
    """The subpackets of a first try past the group prefix, by what they
    hold; read on the host."""
    cull = tables.cull
    *_, K0, _ = conecull.cone_budgets(cull, max_groups, max_candidates)
    wide = group_totals(feats, cull) > K0
    parked = feats[..., 3].reshape(wide.shape[0], -1) >= PARKED   # (P, SP)
    n_parked = parked.sum(dim=1)
    sp = parked.shape[1]
    live_only = wide & (n_parked == 0)
    parked_only = wide & (n_parked == sp)
    return {"K0": K0, "subpackets": wide.numel(),
            "wide": int(wide.sum()), "wide_live_only": int(live_only.sum()),
            "wide_parked_only": int(parked_only.sum()),
            "wide_mixed": int((wide & ~live_only & ~parked_only).sum()),
            "live_slots_in_wide": int((~parked)[wide].sum()),
            "live_slots": int((~parked).sum())}


def main(argv_in=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=12)
    a = p.parse_args(argv_in)
    if not torch.cuda.is_available():
        print("tracer_torch.bench.escalation needs a CUDA device",
              file=sys.stderr)
        return 1
    calls, tries = [], []
    real_checked = leafcull.nearest_hit_leafcull_checked
    real_phase_a = conecull.cone_candidates

    def phase_a(feats, tables, max_groups, max_candidates):
        rows, cones, overflow = real_phase_a(feats, tables, max_groups,
                                             max_candidates)
        tries.append((feats, tables, max_groups, max_candidates, overflow))
        return rows, cones, overflow

    def checked(rays, scene, tables, *args, **kw):
        before = _lib.launches.copy()
        tries.clear()
        rec, esc = real_checked(rays, scene, tables, *args, **kw)
        feats, tbl, mg, mc, _ = tries[0]
        row = {"call": len(calls), "escalations": esc,
               "phase_a_tries": len(tries),
               "launches": {k: _lib.launches[k] - before[k] for k in WALKS}}
        if esc:
            row["first_try"] = first_try(feats, tbl, mg, mc)
            row["first_try"]["overflow"] = bool(tries[0][4])
        calls.append(row)
        tries.clear()
        return rec, esc

    leafcull.nearest_hit_leafcull_checked = checked
    conecull.cone_candidates = phase_a
    try:
        session = cli.prepare(cli.build_parser().parse_args(argv(a.frames)))
        gen = torch.Generator(device=session.device).manual_seed(1)
        from tracer_torch.integrator.wavefront import bounce_noise
        cfg = session.config

        def noise_for(i):
            return bounce_noise(gen, (cfg.height, cfg.width), cfg.max_depth,
                                session.device)

        def after_frame(i, acc):
            torch.cuda.synchronize()
            for b, row in enumerate(calls[-cfg.max_depth:]):
                row.update(frame=i, bounce=b)
                print(json.dumps(row), flush=True)

        cli.render_frames(session, noise_for, after_frame=after_frame)
    finally:
        leafcull.nearest_hit_leafcull_checked = real_checked
        conecull.cone_candidates = real_phase_a
    esc = [r for r in calls if r["escalations"]]
    keys = ("wide", "wide_live_only", "wide_parked_only", "wide_mixed",
            "live_slots_in_wide")
    summary = {
        "device": torch.cuda.get_device_name(0),
        "frames": a.frames, "calls": len(calls), "escalating_calls": len(esc),
        "escalations": Counter(r["escalations"] for r in calls),
        "escalating_bounces": Counter(r["bounce"] for r in esc),
        "launches_per_call": sorted({json.dumps(r["launches"])
                                     for r in calls}),
        "first_try_overflow_matches_wide": all(
            r["first_try"]["overflow"] == (r["first_try"]["wide"] > 0)
            for r in esc),
        **{k: sum(r["first_try"][k] for r in esc) for k in keys}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
