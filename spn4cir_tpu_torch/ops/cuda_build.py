"""Build the package's CUDA sources into plain-C shared libraries.

Each library is compiled by `nvcc` for Hopper (`sm_90a`) at first use, for
its wrapper to load with `ctypes`; nothing is built when a module is
imported. Outputs go to `build/kernels/` at the root of the checkout, named
by a hash of the sources, the shared `.cuh` headers and the flags, so an
edited source rebuilds and an unchanged one loads the library already there.
The `ptxas` report (registers, shared memory, spills) is kept beside each
library as `<name>-<hash>.log`.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or /usr/local/cuda/bin)")


def build_library(name: str, sources: Sequence[str], force: bool = False
                  ) -> Path:
    """Compile `sources` (file names under csrc/) into one shared library
    unless the library for these exact sources exists (or `force`);
    returns its path."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the shared headers too: a source may include any of them
    for src in [*sources, *sorted(p.name for p in CSRC_DIR.glob("*.cuh"))]:
        digest.update((CSRC_DIR / src).read_bytes())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a temp name of this process and thread, then an atomic rename: no
    # lock, so libraries build in parallel when threads ask for them
    # together, and nobody ever dlopens a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC_DIR / s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out
