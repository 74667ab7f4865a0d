"""Builds the port's native libraries from sources in the checkout.

Every library goes to ``build/tracer_torch/`` at the root of the checkout
(git-ignored) on first use, and is rebuilt when any of its sources or
headers is newer. Each source compiles to an object in its own compiler
process, all started together, and the objects are then linked. The link
writes into a temporary directory and the library is renamed into place,
so concurrent processes never load a half-written library.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
BUILD_DIR = REPO_ROOT / "build" / "tracer_torch"


def _run_all(cmds: list[list[str]], timeout: float) -> list[str]:
    """Run ``cmds`` at once; returns their outputs. Raises RuntimeError on
    the first failure or at ``timeout`` seconds, after stopping them all."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for cmd, p in zip(cmds, procs):
            try:
                out, _ = p.communicate(
                    timeout=max(deadline - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"{' '.join(cmd)} took over {timeout} s")
            if p.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)} failed:\n{out}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def build_shared_library(compiler: str, compile_flags: list[str],
                         link_flags: list[str], sources: list[Path],
                         out_name: str, depends: list[Path] = (),
                         timeout: float = 600.0) -> tuple[Path, str]:
    """Compile ``sources`` in parallel and link ``BUILD_DIR / out_name``
    unless it is newer than every source and every file in ``depends``.

    Returns (library path, compiler output; empty when nothing was built).
    Raises RuntimeError when the compiler is missing or the build fails.
    """
    out = BUILD_DIR / out_name
    newest = max(os.path.getmtime(s) for s in [*sources, *depends])
    if out.exists() and out.stat().st_mtime >= newest:
        return out, ""
    if shutil.which(compiler) is None:
        raise RuntimeError(f"cannot build {out_name}: {compiler} not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix=f".{out_name}.", dir=BUILD_DIR))
    try:
        objs = [work / f"{i}_{s.stem}.o" for i, s in enumerate(sources)]
        logs = _run_all([[compiler, *compile_flags, "-c", str(s), "-o",
                          str(o)] for s, o in zip(sources, objs)], timeout)
        lib = work / out_name
        logs += _run_all([[compiler, *link_flags, "-o", str(lib),
                           *map(str, objs)]], timeout)
        os.replace(lib, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out, "".join(logs)
