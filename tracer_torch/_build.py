"""Builds the port's native libraries from sources in the checkout.

Every library goes to ``build/tracer_torch/`` at the root of the checkout
(git-ignored) on first use, and is rebuilt when any of its sources is newer.
A build writes a temporary file and renames it into place, so concurrent
processes never load a half-written library.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
BUILD_DIR = REPO_ROOT / "build" / "tracer_torch"


def build_shared_library(compiler: str, flags: list[str],
                         sources: list[Path], out_name: str,
                         timeout: float = 600.0) -> tuple[Path, str]:
    """Compile ``sources`` into ``BUILD_DIR / out_name`` unless it is fresh.

    Returns (library path, compiler output; empty when nothing was built).
    Raises RuntimeError when the compiler is missing or the build fails.
    """
    out = BUILD_DIR / out_name
    newest = max(os.path.getmtime(s) for s in sources)
    if out.exists() and out.stat().st_mtime >= newest:
        return out, ""
    if shutil.which(compiler) is None:
        raise RuntimeError(f"cannot build {out_name}: {compiler} not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out_name}.{os.getpid()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {out_name} failed:\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr
