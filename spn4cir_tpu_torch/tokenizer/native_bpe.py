"""ctypes binding for the native CLIP-BPE fast path (`native/bpe.cpp`).

Counterpart of `spn4cir_tpu/tokenizer/native_bpe.py`. Built with g++ at
first use into `build/native/` (the loader's convention,
`native.compile_library`); `SPN4CIR_NATIVE=0` opts out. `NativeBpe.encode`
returns None whenever the input leaves the ASCII fast-path contract (bytes
>= 0x80, HTML entities, literal special tokens, unknown symbols, a NUL):
the caller then runs the Python tokenizer, so results are always
byte-identical to `tokenizer/bpe.py`.

A library at the expected path that lacks the batch entry point (a stale
copy put there by hand or by an mtime-preserving deploy) is rebuilt once
and loaded through a unique path: glibc's dlopen dedupes by path name, so
loading the same path again would return the stale mapping.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
import weakref
from typing import List, Optional

import numpy as np

from spn4cir_tpu_torch.native import NATIVE_DIR, compile_library, native_enabled

_SRC = NATIVE_DIR / "bpe.cpp"
_LINK = ("-pthread",)
_BUILD_LOCK = threading.Lock()

_lib = None
_build_error: Optional[str] = None


def _open(path) -> Optional[ctypes.CDLL]:
    global _build_error
    try:
        return ctypes.CDLL(str(path))
    except OSError as exc:
        _build_error = str(exc)
        return None


def _load():
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return
    with _BUILD_LOCK:
        if _lib is not None or _build_error is not None:
            return
        path, err = compile_library("bpe", _SRC, _LINK)
        if err:
            _build_error = err
            return
        lib = _open(path)
        if lib is None:
            return
        if not hasattr(lib, "bpe_encode_batch"):
            path, err = compile_library("bpe", _SRC, _LINK, force=True)
            if err:
                _build_error = err
                return
            fresh = f"{path}.{os.getpid()}.reload"
            shutil.copyfile(path, fresh)
            try:
                lib = _open(fresh)
            finally:
                os.unlink(fresh)   # the mapping outlives the name
            if lib is None:
                return
            if not hasattr(lib, "bpe_encode_batch"):
                _build_error = "the rebuilt bpe library lacks bpe_encode_batch"
                return
        lib.bpe_create.restype = ctypes.c_void_p
        lib.bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.bpe_destroy.argtypes = [ctypes.c_void_p]
        lib.bpe_encode.restype = ctypes.c_int
        lib.bpe_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int32),
                                   ctypes.c_int]
        lib.bpe_encode_batch.restype = None
        lib.bpe_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int]
        _lib = lib


def native_available() -> bool:
    """Whether the fast path is on: `SPN4CIR_NATIVE` is not 0 and the
    library built (it is built here, at the first call)."""
    if not native_enabled():
        return False
    _load()
    return _lib is not None


def build_error() -> Optional[str]:
    """The build's error, or None; builds the library if it was not."""
    _load()
    return _build_error


def _utf8(text: str) -> Optional[bytes]:
    """The C string of `text`, or None where it cannot be one (a NUL would
    truncate it; a lone surrogate does not encode)."""
    if "\x00" in text:
        return None
    try:
        return text.encode("utf-8")
    except UnicodeEncodeError:
        return None


class NativeBpe:
    def __init__(self, tokenizer):
        _load()
        if _lib is None:
            raise RuntimeError(_build_error or "native bpe unavailable")
        # only pure-ASCII vocab / merge entries can ever apply on the ASCII
        # fast path (printable ASCII is the identity under the byte table)
        enc = "".join(f"{tok}\t{i}\n" for tok, i in tokenizer.encoder.items()
                      if tok.isascii())
        ranks = "".join(f"{a}\t{b}\t{r}\n"
                        for (a, b), r in tokenizer._rank.items()
                        if a.isascii() and b.isascii())
        self._h = _lib.bpe_create(enc.encode(), ranks.encode())

    def __del__(self):
        if _lib is not None and getattr(self, "_h", None):
            _lib.bpe_destroy(self._h)

    def encode(self, text: str) -> Optional[List[int]]:
        """BPE ids, or None when the text needs the Python fallback.
        Thread-safe: the output buffer is per call and the C side's word
        cache has its own mutex."""
        raw = _utf8(text)
        if raw is None:
            return None
        buf = np.empty(512, np.int32)
        while True:
            n = _lib.bpe_encode(
                self._h, raw,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(buf))
            if n < 0:
                return None
            if n <= len(buf):
                return buf[:n].tolist()
            buf = np.empty(n, np.int32)

    def encode_batch(self, texts: List[str], max_ids: int = 256,
                     threads: int = 0) -> List[Optional[List[int]]]:
        """Encode many texts in one FFI call (rows spread over C++ threads).
        One entry per text: the ids, or None where the text needs the
        Python fallback (outside the contract, or longer than
        `max_ids`)."""
        n = len(texts)
        if n == 0:
            return []
        raws = [_utf8(t) for t in texts]
        offsets = np.empty(n, np.int64)
        blob = bytearray()
        for i, raw in enumerate(raws):
            offsets[i] = len(blob)
            blob += (raw if raw is not None else b"") + b"\x00"
        out = np.empty((n, max_ids), np.int32)
        lens = np.empty(n, np.int32)
        _lib.bpe_encode_batch(
            self._h, bytes(blob),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max_ids, threads)
        return [None if raws[i] is None or not 0 <= lens[i] <= max_ids
                else out[i, :lens[i]].tolist() for i in range(n)]


# weak keys: a collected tokenizer must not leave an entry behind for a new
# object that reuses its id()
_instances: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_instances_lock = threading.Lock()


def get_native(tokenizer) -> Optional[NativeBpe]:
    """The tokenizer's NativeBpe (one per tokenizer); None when the library
    is unavailable or `SPN4CIR_NATIVE=0`."""
    if not native_available():
        return None
    with _instances_lock:
        inst = _instances.get(tokenizer)
        if inst is None:
            inst = _instances[tokenizer] = NativeBpe(tokenizer)
        return inst
