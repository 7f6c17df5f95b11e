"""How the port reaches a hand-written kernel (`ops/cuda_build.py`), on the
CPU with the CUDA calls stubbed: `launch` passes the raw current stream of
the tensors' device last, takes that device's guard only when it is not
the current one, raises naming the wrapper on a non-zero code and counts a
launch only when it succeeds; every wrapper that launches is registered,
and a graph's capture counts nothing while each replay counts its launches
(`capturing`, `replayed`); `occupancy` and `sm_count` read the device
facts; `load_library` applies each library's entry table, and every table
is its `csrc/<name>.cu`'s C declaration. The kernels themselves run on the
card (`tests/test_torch_cuda.py`)."""

import contextlib
import ctypes
import re

import pytest
import torch

from spn4cir_tpu_torch.ops import attention_kernels as ak
from spn4cir_tpu_torch.ops import bank_kernels as bk
from spn4cir_tpu_torch.ops import cuda_build
from spn4cir_tpu_torch.ops import decode_attn as da
from spn4cir_tpu_torch.ops import kda as kk
from spn4cir_tpu_torch.ops import layer_norm as lnk
from spn4cir_tpu_torch.ops import maxquery_kernels as mk
from spn4cir_tpu_torch.ops import moe_grouped as moe
from spn4cir_tpu_torch.ops import quant_matmul as qm

# every library the package builds, and the entry table its wrapper
# module loads it with
LIBRARIES = {
    "short_attention": ak.SHORT_ENTRY_POINTS,
    "long_attention": ak.LONG_ENTRY_POINTS,
    "bank_infonce": bk.ENTRY_POINTS,
    "max_query_infonce": mk.ENTRY_POINTS,
    "decode_attention": da.ENTRY_POINTS,
    "quant_matmul": qm.ENTRY_POINTS,
    "layer_norm": lnk.ENTRY_POINTS,
    "moe_grouped": moe.ENTRY_POINTS,
    "kda": kk.ENTRY_POINTS,
}


class _Device:
    """CUDA's current device and guard, stubbed: records each guard it
    enters and makes that device current inside it."""

    def __init__(self, current: int):
        self.current = current
        self.entered = []

    @contextlib.contextmanager
    def guard(self, index):
        self.entered.append(index)
        before, self.current = self.current, index
        try:
            yield
        finally:
            self.current = before


@pytest.fixture
def cuda(monkeypatch):
    dev = _Device(current=0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: dev.current)
    monkeypatch.setattr(torch.cuda, "device", dev.guard)
    return dev


class _Entry:
    """A stand-in entry point: returns `code`, records its arguments and
    the device current when it ran."""

    __name__ = "toy_entry"
    argtypes = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p)

    def __init__(self, dev: _Device, code: int = 0):
        self.dev, self.code, self.calls = dev, code, []

    def __call__(self, *args):
        self.calls.append((args, self.dev.current))
        return self.code


def _wrapper():
    def toy_wrapper():
        pass
    toy_wrapper.launches = 0
    return toy_wrapper


def test_launch_passes_the_devices_raw_stream_last(cuda):
    fn, wrapper = _Entry(cuda), _wrapper()
    cuda_build.launch(wrapper, fn, 0, 0xbeef, 3, 0.5)
    cuda_build.launch(wrapper, fn, 1, 0xbeef, 3, 0.5)
    assert [args for args, _ in fn.calls] == [(0xbeef, 3, 0.5, 1000),
                                             (0xbeef, 3, 0.5, 1001)]


@pytest.mark.parametrize("current", [0, 1])
def test_launch_takes_the_guard_only_off_the_current_device(cuda, current):
    cuda.current = current
    fn = _Entry(cuda)
    cuda_build.launch(_wrapper(), fn, 1, 0xbeef, 3, 0.5)
    assert cuda.entered == ([] if current == 1 else [1])
    assert fn.calls[0][1] == 1          # the kernel's device was current
    assert cuda.current == current      # and the caller's is again


def test_failed_launch_raises_naming_the_wrapper_and_counts_nothing(cuda):
    fn, wrapper = _Entry(cuda, code=700), _wrapper()
    with pytest.raises(RuntimeError,
                       match=r"toy_wrapper launch failed with CUDA error 700 "
                             r"on cuda:1 \(scalar arguments of toy_entry: "
                             r"\[3, 0\.5\]\)"):
        cuda_build.launch(wrapper, fn, 1, 0xbeef, 3, 0.5)
    assert wrapper.launches == 0


def test_launch_counts_each_success_once(cuda):
    fn, wrapper = _Entry(cuda), _wrapper()
    for n in (1, 2, 3):
        cuda_build.launch(wrapper, fn, 0, 0xbeef, 3, 0.5)
        assert wrapper.launches == n
    assert len(fn.calls) == 3


def test_every_launching_wrapper_is_counted():
    """The registry holds each public wrapper that a module hands to
    `launch`, once, and nothing else."""
    modules = (ak, bk, da, kk, lnk, mk, moe, qm)
    launched = set()
    for module in modules:
        with open(module.__file__) as f:
            launched |= set(re.findall(r"\blaunch\((\w+),", f.read()))
    # the bank module hands `launch` the wrapper `_bank_args` picks
    launched = launched - {"wrapper"} | {
        "bank_infonce_fwd", "bank_infonce_bwd", "bank_infonce_q8_fwd",
        "bank_infonce_q8_bwd"}
    names = [w.__name__ for w in cuda_build.COUNTED]
    assert len(names) == len(set(names)) == 17
    assert set(names) == launched
    for w in cuda_build.COUNTED:
        assert getattr(__import__(w.__module__, fromlist=["_"]),
                       w.__name__) is w


def _counted(monkeypatch, *names):
    monkeypatch.setattr(cuda_build, "COUNTED", [])
    wrappers = []
    for name in names:
        wrapper = _wrapper()
        wrapper.__name__ = name
        cuda_build.counted(wrapper)
        wrappers.append(wrapper)
    return wrappers


def test_a_capture_counts_nothing_and_each_replay_its_launches(cuda,
                                                                monkeypatch):
    """What the wrappers counted inside `capturing()` is taken back and
    yielded, a wrapper registered meanwhile from 0; `replayed` adds it on
    each replay, and launches outside the graph count as before."""
    a, b = _counted(monkeypatch, "a", "b")
    fn = _Entry(cuda)
    cuda_build.launch(a, fn, 0, 0xbeef, 3, 0.5)
    with cuda_build.capturing() as launches:
        for _ in range(39):
            cuda_build.launch(a, fn, 0, 0xbeef, 3, 0.5)
        (c,) = (_wrapper(),)
        c.__name__ = "c"
        cuda_build.counted(c)
        for _ in range(79):
            cuda_build.launch(c, fn, 0, 0xbeef, 3, 0.5)
    assert [(w.__name__, n) for w, n in launches] == [("a", 39), ("c", 79)]
    assert (a.launches, b.launches, c.launches) == (1, 0, 0)
    for replay in (1, 2, 3):
        cuda_build.replayed(launches)
        assert (a.launches, b.launches, c.launches) == (1 + 39 * replay, 0,
                                                        79 * replay)
    cuda_build.launch(b, fn, 0, 0xbeef, 3, 0.5)
    assert (a.launches, b.launches) == (118, 1)


def test_a_capture_that_raises_counts_nothing(cuda, monkeypatch):
    (a,) = _counted(monkeypatch, "a")
    fn = _Entry(cuda)
    with pytest.raises(RuntimeError, match="capture failed"):
        with cuda_build.capturing():
            cuda_build.launch(a, fn, 0, 0xbeef, 3, 0.5)
            raise RuntimeError("capture failed")
    assert a.launches == 0


class _Occupancy:
    """A stand-in occupancy entry point: writes `count`, returns `code`."""

    __name__ = "toy_occupancy"

    def __init__(self, dev: _Device, count: int, code: int = 0):
        self.dev, self.count, self.code, self.seen = dev, count, code, []

    def __call__(self, *args):
        *query, out = args
        self.seen.append((tuple(query), self.dev.current))
        out._obj.value = self.count
        return self.code


@pytest.mark.parametrize("count, code, least, ok", [
    (3, 0, 1, True), (0, 0, 0, True), (0, 0, 1, False), (3, 2, 1, False)])
def test_occupancy_asks_under_the_devices_guard(cuda, count, code, least, ok):
    fn = _Occupancy(cuda, count, code)
    if ok:
        assert cuda_build.occupancy(fn, 1, 7, 8, least=least) == count
    else:
        with pytest.raises(RuntimeError, match=rf"toy_occupancy\(7, 8\) "
                                               rf"failed with CUDA error "
                                               rf"{code} \({count}\)"):
            cuda_build.occupancy(fn, 1, 7, 8, least=least)
    assert fn.seen == [((7, 8), 1)] and cuda.entered == [1]


def test_sm_count_reads_the_devices_properties(monkeypatch):
    props = {0: 132, 1: 114}
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda i: type("Props", (), {"multi_processor_count": props[i]}))
    assert [cuda_build.sm_count.__wrapped__(i) for i in (0, 1)] == [132, 114]


class _Lib:
    """`ctypes.CDLL` stubbed: every symbol is a plain object."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, entry):
        fn = type("Fn", (), {})()
        setattr(self, entry, fn)
        return fn


@pytest.mark.parametrize("name", list(LIBRARIES))
def test_loader_applies_the_entry_table_once(name, monkeypatch):
    built = []
    monkeypatch.setattr(cuda_build, "build_library",
                        lambda n, srcs: built.append((n, srcs)) or f"{n}.so")
    monkeypatch.setattr(cuda_build, "_LIBRARIES", {})
    monkeypatch.setattr(ctypes, "CDLL", _Lib)
    entries = LIBRARIES[name]
    lib = cuda_build.load_library(name, entries)
    assert lib.path == f"{name}.so" and built == [(name, [f"{name}.cu"])]
    for entry, argtypes in entries.items():
        fn = getattr(lib, entry)
        assert fn.restype is ctypes.c_int
        assert fn.argtypes == list(argtypes)
    assert cuda_build.load_library(name, entries) is lib
    assert len(built) == 1


_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}


def _c_entry_points(name):
    """{entry: [parameter type]} of every `extern "C"` function of
    csrc/<name>.cu, pointers as "*"."""
    src = (cuda_build.CSRC_DIR / f"{name}.cu").read_text()
    out = {}
    for entry, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        types = []
        for p in params.split(","):
            p = re.sub(r"\bconst\b", "", p).strip()
            types.append("*" if "*" in p else p.rsplit(None, 1)[0])
        out[entry] = types
    return out


@pytest.mark.parametrize("name", list(LIBRARIES))
def test_entry_table_is_the_c_declaration(name):
    """Each table names every entry point of its source, with one argtype
    a parameter: a pointer for a pointer, the C scalar's ctypes twin
    otherwise."""
    declared = _c_entry_points(name)
    table = LIBRARIES[name]
    assert set(table) == set(declared)
    for entry, params in declared.items():
        got = list(table[entry])
        assert len(got) == len(params), entry
        for t, p in zip(got, params):
            if p == "*":
                assert t is ctypes.c_void_p or issubclass(t, ctypes._Pointer)
            else:
                assert t is _C_TYPES[p], (entry, p, t)
