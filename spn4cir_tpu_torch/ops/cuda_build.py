"""Build the package's CUDA sources into plain-C shared libraries, load
them with `ctypes` and launch their entry points.

Each library is compiled by `nvcc` for Hopper (`sm_90a`) at first use;
nothing is built when a module is imported. Outputs go to `build/kernels/`
at the root of the checkout, named by a hash of the sources, the shared
`.cuh` headers and the flags, so an edited source rebuilds and an unchanged
one loads the library already there. The `ptxas` report (registers, shared
memory, spills) is kept beside each library as `<name>-<hash>.log`.

This module is the one way Python reaches a kernel. A wrapper module
declares each library's entry points as data (name -> argtypes; every entry
returns a CUDA error code as `c_int`), and:
  - `load_library` builds `csrc/<name>.cu` and opens it, once a process;
  - `launch` calls an entry point on the current stream of the tensors'
    device, raises on its error code and counts the launch in the public
    wrapper's `.launches`;
  - `sm_count` and `occupancy` read the device facts a plan needs.

Launch counters. Each public wrapper is registered by `counted`, and its
`.launches` counts the launches put on the device through it. `launch`
adds 1 for each kernel it launches. A CUDA graph's capture runs nothing, so
a graph helper captures inside `capturing()`, which takes back what the
wrappers counted meanwhile and yields it, and adds it again on every replay
with `replayed`.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Mapping, Sequence, Tuple

import torch

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


#: entry point -> its argtypes, the current stream's handle last
EntryPoints = Mapping[str, Sequence[type]]

_LIBRARIES: Dict[str, ctypes.CDLL] = {}
_SCALARS = (ctypes.c_int, ctypes.c_longlong, ctypes.c_float)


def load_library(name: str, entries: EntryPoints) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu`, opened once a process, with
    each entry point of `entries` given its argtypes and a `c_int` result."""
    lib = _LIBRARIES.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_library(name, [f"{name}.cu"])))
        for entry, argtypes in entries.items():
            fn = getattr(lib, entry)
            fn.restype = ctypes.c_int
            fn.argtypes = list(argtypes)
        lib = _LIBRARIES.setdefault(name, lib)
    return lib


def launch(wrapper: Callable, fn, index: int, *args) -> None:
    """`fn(*args, stream)` with the raw current stream of CUDA device
    `index` (under `torch.cuda.graph` capture, the capture stream), under
    that device's guard only when it is not the current one. A non-zero
    code raises RuntimeError naming `wrapper`; a launch that succeeds adds
    1 to `wrapper.launches`. Nothing else is paid a launch: the error text
    is built only on failure."""
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err != 0:
        scalars = [a for a, t in zip(args, fn.argtypes) if t in _SCALARS]
        raise RuntimeError(f"{wrapper.__name__} launch failed with CUDA error "
                           f"{err} on cuda:{index} (scalar arguments of "
                           f"{fn.__name__}: {scalars})")
    wrapper.launches += 1


#: the wrappers that count their launches, in the order registered
COUNTED: List[Callable] = []

#: (wrapper, launches) pairs: what one run of a captured graph launches
Launches = List[Tuple[Callable, int]]


def counted(*wrappers: Callable) -> None:
    """Register public wrappers whose launches `launch` counts, each
    `.launches` from 0."""
    for wrapper in wrappers:
        wrapper.launches = 0
        COUNTED.append(wrapper)


@contextlib.contextmanager
def capturing() -> Iterator[Launches]:
    """Around a CUDA graph's capture: yields a list that, on exit, holds
    what each counted wrapper launched into the graph, and takes that back
    from its `.launches` (the capture ran nothing). Give the list to
    `replayed` at every replay of the graph."""
    before = [w.launches for w in COUNTED]
    launches: Launches = []
    try:
        yield launches
    finally:
        # a wrapper registered meanwhile (its module imported) counted from 0
        for i, wrapper in enumerate(COUNTED):
            n = wrapper.launches - (before[i] if i < len(before) else 0)
            if n:
                wrapper.launches -= n
                launches.append((wrapper, n))


def replayed(launches: Launches) -> None:
    """Count one replay of a graph captured under `capturing()`."""
    for wrapper, n in launches:
        wrapper.launches += n


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def occupancy(fn, index: int, *args, least: int = 1) -> int:
    """What the occupancy entry point `fn(*args, &count)` of a library
    reports on CUDA device `index`, asked under its guard; RuntimeError on
    a CUDA error or a count below `least`."""
    count = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = fn(*args, ctypes.byref(count))
    if err != 0 or count.value < least:
        raise RuntimeError(f"{fn.__name__}{args} failed with CUDA error {err} "
                           f"({count.value}) on cuda:{index}")
    return count.value
