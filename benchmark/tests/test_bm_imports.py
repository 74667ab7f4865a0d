"""What a cell's run loads and reads: no JAX and nothing of the JAX
package. A subprocess runs every tiny cell on the CPU, untraced and
traced, with an audit hook on every file it opens, then lists the
top-level names of every module loaded; each is compared whole, so
``tracer_torch`` passes where ``tracer`` would not."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap

from benchmark.harness import FORBIDDEN, HERE

REPO = HERE.parent
NOT_READ = ("bench.py", "tracer", "tools", "results")

SCRIPT = textwrap.dedent("""
    import json, sys
    opened = []
    sys.addaudithook(lambda ev, a: opened.append(str(a[0]))
                     if ev == "open" and a and isinstance(a[0], str)
                     else None)
    from pathlib import Path
    import torch
    torch.set_num_threads(2)
    from benchmark.tests import tiny
    import benchmark.run
    bench = tiny.make(Path(sys.argv[1]))
    for cell in tiny.CELLS:
        for trace in (False, True):
            tiny.run(bench, cell, trace=trace)
    print(json.dumps({"modules": sorted({m.split(".")[0]
                                         for m in sys.modules}),
                      "opened": opened}))
""")


def test_a_run_loads_no_jax_and_reads_nothing_of_the_jax_package(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    names = set(rec["modules"])
    assert "tracer_torch" in names and "benchmark" in names
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)
    for path in rec["opened"]:
        p = os.path.abspath(path)
        if not p.startswith(str(REPO) + os.sep):
            continue
        rel = os.path.relpath(p, REPO).split(os.sep)
        assert rel[0] not in NOT_READ, p
        assert not rel[0].startswith(("BENCH_", "MULTICHIP_")), p


def test_run_refuses_without_a_card_or_without_the_port(tmp_path):
    """Without CUDA it exits non-zero and prints no result; so it does in
    a directory that holds only the manifest and the benchmark."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (REPO, tmp_path):
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", "query_100k",
             "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
            cwd=cwd, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0
        assert out.stdout.strip() == ""
