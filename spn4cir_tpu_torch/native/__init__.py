"""Native (C++) host code of the port: the image loader and its bindings.

`loader.cpp` (a copy of the JAX package's, with the same C API) decodes
JPEG / PNG with libjpeg / libpng on a pool of threads and either runs the
whole CIR preprocess (pad -> bicubic resize -> center crop -> normalize,
geometry as `data/transforms.py:ImageTransform`) or only stages the decoded
image into a uint8 canvas for the device preprocess (`ops/preprocess.py`).
It is bound with ctypes (`NativeLoader`, `NativeRawStager`).

The shared object is built with g++ at first use, never at import, into
`build/native/` at the root of the checkout, named by a digest of the
source, the flags and the host (`-march=native` code must not run on
another CPU); the build runs under a file lock, to a temporary name of the
process and then an atomic rename, so concurrent processes never load a
half-written library. `native_available()` / `build_error()` say whether
it built; `SPN4CIR_NATIVE=0` makes the port's callers keep to PIL
(`native_enabled()`).

This module imports no torch: the multi-process loader's workers import it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
#: the transform kinds the C++ preprocess implements (blip_eval resizes
#: straight to (dim, dim) and stays on PIL; its raw staging is 'clip's)
KINDS = {"clip": 0, "squarepad": 1, "targetpad": 2}

_BUILD_LOCK = threading.Lock()
_lib = None
_build_error: Optional[str] = None


def native_enabled() -> bool:
    """False when `SPN4CIR_NATIVE` is 0 or false: callers then keep to PIL
    and the Python tokenizer."""
    return os.environ.get("SPN4CIR_NATIVE", "1") not in ("0", "false")


def library_path(name: str, src: Path, flags: Sequence[str]) -> Path:
    """Where the library of `src` built with `flags` on this host lives."""
    digest = hashlib.sha256(" ".join(flags).encode())
    digest.update("/".join((platform.machine(), platform.node(),
                            platform.processor())).encode())
    digest.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def compile_library(name: str, src: Path, link: Sequence[str] = (),
                    force: bool = False) -> Tuple[Optional[Path], Optional[str]]:
    """Build `src` into a shared library unless it is there already (or
    `force`); returns (path, None) or (None, the compiler's error)."""
    out = library_path(name, src, CXX_FLAGS + tuple(link))
    if out.exists() and not force:
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)    # another process may be building
        if out.exists() and not force:
            return out, None
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, str(src), "-o", str(tmp), *link]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as exc:
            return None, f"g++ failed for {name}: {exc}"
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            return None, f"g++ failed for {name}: {proc.stderr[-2000:]}"
        os.replace(tmp, out)
    return out, None


def _load():
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return
    with _BUILD_LOCK:
        if _lib is not None or _build_error is not None:
            return
        path, err = compile_library("loader", NATIVE_DIR / "loader.cpp",
                                    ("-ljpeg", "-lpng", "-lpthread"))
        if err:
            _build_error = err
            return
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            _build_error = str(exc)
            return
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [ctypes.c_int]
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        lib.loader_decode_batch.restype = ctypes.c_int
        lib.loader_decode_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int8),
        ]
        lib.loader_stage_raw_batch.restype = ctypes.c_int
        lib.loader_stage_raw_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int8),
        ]
        _lib = lib


def native_available() -> bool:
    """Whether the loader library built and loaded (it is built here, at
    the first call)."""
    _load()
    return _lib is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def loaded_library() -> Optional[str]:
    """The path of the loaded loader library, or None."""
    _load()
    return None if _lib is None else _lib._name


def _pool(num_threads: int):
    _load()
    if _lib is None:
        raise RuntimeError(f"native loader unavailable: {_build_error}")
    return _lib.loader_create(num_threads or min(8, os.cpu_count() or 1))


def _paths_arg(paths: Sequence[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


class NativeLoader:
    """Threaded decode + preprocess: paths -> (B, dim, dim, 3) float32 HWC,
    in place of mapping `ImageTransform` over PIL decodes."""

    def __init__(self, kind: str, dim: int, target_ratio: float = 1.25,
                 mean: Sequence[float] = (0.48145466, 0.4578275, 0.40821073),
                 std: Sequence[float] = (0.26862954, 0.26130258, 0.27577711),
                 num_threads: int = 0, fallback=None):
        """`fallback(path) -> (dim, dim, 3) float32` takes the images the
        C++ decoder declines (status 2: palette-mode PNGs, which Pillow
        resizes NEAREST and pads with palette[0]) or fails on (status 1).
        Without a fallback those images raise IOError."""
        self.kind = KINDS[kind]
        self._pool = _pool(num_threads)
        self.fallback = fallback
        self.dim = dim
        self.target_ratio = float(target_ratio)
        self._mean = (ctypes.c_float * 3)(*[float(m) for m in mean])
        self._std = (ctypes.c_float * 3)(*[float(s) for s in std])

    def __del__(self):
        if getattr(self, "_pool", None) and _lib is not None:
            _lib.loader_destroy(self._pool)
            self._pool = None

    def decode_batch(self, paths: Sequence[str],
                     out: Optional[np.ndarray] = None) -> np.ndarray:
        """Decode into `out` when given (a shared-memory block in the
        multi-process loader's workers), else into a fresh array."""
        n = len(paths)
        if out is None:
            out = np.empty((n, self.dim, self.dim, 3), np.float32)
        assert out.dtype == np.float32 and out.shape == (
            n, self.dim, self.dim, 3) and out.flags.c_contiguous
        status = np.zeros(n, np.int8)
        failures = _lib.loader_decode_batch(
            self._pool, _paths_arg(paths), n, self.kind, self.dim,
            ctypes.c_float(self.target_ratio), self._mean, self._std,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
        if failures:
            bad = np.nonzero(status)[0]
            if self.fallback is None:
                raise IOError(f"native loader failed on {failures}/{n} images"
                              f" (first: {paths[int(bad[0])]!r})")
            for i in bad:
                out[int(i)] = self.fallback(paths[int(i)])
        return out


class NativeRawStager:
    """Threaded decode-only staging for the device preprocess
    (`--device_preprocess`): paths -> ((B, C, C, 3) uint8 canvases, (B, 2)
    int32 padded extents). The bicubic resize, the dominant host cost, runs
    on the device (`ops/preprocess.py:preprocess_batch_dynamic`)."""

    def __init__(self, kind: str, canvas: int, target_ratio: float = 1.25,
                 num_threads: int = 0, fallback=None):
        """`fallback(path) -> ((C, C, 3) uint8, (ph, pw))` takes the images
        the C++ decoder declines (see NativeLoader); without one they
        raise."""
        self._pool = _pool(num_threads)
        self.fallback = fallback
        # blip_eval stages like 'clip': raw paste, no pad
        self.kind = KINDS.get(kind, 0)
        self.canvas = canvas
        self.target_ratio = float(target_ratio)

    def __del__(self):
        if getattr(self, "_pool", None) and _lib is not None:
            _lib.loader_destroy(self._pool)
            self._pool = None

    def stage_batch(self, paths: Sequence[str],
                    out: Optional[np.ndarray] = None,
                    extents: Optional[np.ndarray] = None):
        """Stage into `out` / `extents` when given (shared-memory blocks in
        the multi-process loader's workers), else into fresh arrays."""
        n = len(paths)
        c = self.canvas
        if out is None:
            out = np.empty((n, c, c, 3), np.uint8)
        if extents is None:
            extents = np.empty((n, 2), np.int32)
        assert out.dtype == np.uint8 and out.shape == (n, c, c, 3) \
            and out.flags.c_contiguous
        assert extents.dtype == np.int32 and extents.shape == (n, 2) \
            and extents.flags.c_contiguous
        status = np.zeros(n, np.int8)
        failures = _lib.loader_stage_raw_batch(
            self._pool, _paths_arg(paths), n, self.kind, c,
            ctypes.c_float(self.target_ratio),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            extents.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
        if failures:
            bad = np.nonzero(status)[0]
            if self.fallback is None:
                raise IOError(f"native stager failed on {failures}/{n} images"
                              f" (first: {paths[int(bad[0])]!r})")
            for i in bad:
                canv, ext = self.fallback(paths[int(i)])
                out[int(i)] = canv
                extents[int(i)] = ext
        return out, extents
