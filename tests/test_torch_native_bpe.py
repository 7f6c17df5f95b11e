"""The port's native CLIP-BPE fast path (`tokenizer/native_bpe.py` over
`native/bpe.cpp`) against the Python tokenizers of both packages, over the
synthetic merges table (the real merges file is not in the repository).

Tolerance: none; the ids must be identical to the JAX package's Python
tokenizer and to the port's Python path, and a text outside the fast path's
contract must come back as None (the Python path then runs).
"""

import os
import random
import string
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from spn4cir_tpu.tokenizer.bpe import ClipTokenizer as JaxClipTokenizer
from spn4cir_tpu_torch.tokenizer import native_bpe
from spn4cir_tpu_torch.tokenizer.bpe import tokenize
from tests.torch_fixtures import synthetic_merges, synthetic_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CAPTIONS = [
    "is shorter and has a floral pattern",
    "The dress is  BLUE   with   white dots!!",
    "it's got 3 buttons, isn't it? they're #1 (no. 42)",
    "a-line; v-neck... 100% cotton's 'look'",
    "I'll we've you're can't don'T O'Brien's",
    "",
    "   ",
    "word",
    "x",
    "9",
    "don't---stop; 'tis ok",
    "semi--colons;;; and 'quotes' \"here\"",
    "tabs\tand\nnewlines\r\nmixed   spaces",
    "make it like number 7 but red",
    "change the dog to a cat sitting on the grass",
]
FALLBACK = ["café au lait", "&amp; escaped", "<|startoftext|> hi",
            "emoji \U0001f642 here", "nul\x00byte"]


@pytest.fixture(scope="module")
def tok():
    return synthetic_tokenizer()


@pytest.fixture(scope="module")
def jax_tok():
    return JaxClipTokenizer(merges=synthetic_merges())


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def nb(tok, monkeypatch_module):
    monkeypatch_module.delenv("SPN4CIR_NATIVE", raising=False)
    assert native_bpe.native_available(), native_bpe.build_error()
    got = native_bpe.get_native(tok)
    assert got is not None
    return got


def _fuzz(seed, n, alphabet, max_len):
    rnd = random.Random(seed)
    return ["".join(rnd.choice(alphabet) for _ in range(rnd.randint(0, max_len)))
            for _ in range(n)]


def test_known_captions_match_both_python_paths(tok, jax_tok, nb):
    for cap in CAPTIONS:
        got = nb.encode(cap)
        assert got is not None, cap
        assert got == tok._encode_py(cap) == jax_tok._encode_py(cap), cap
        assert tok.encode(cap) == got


def test_fuzz_ascii_matches_python(tok, jax_tok, nb):
    alphabet = (string.ascii_letters + string.digits + string.punctuation
                + "  '").replace("&", "")
    for s in _fuzz(0, 400, alphabet, 40):
        if "<|" in s:
            continue
        got = nb.encode(s)
        assert got is not None, repr(s)
        assert got == tok._encode_py(s) == jax_tok._encode_py(s), repr(s)


def test_fallback_cases(tok, jax_tok, nb):
    for s in FALLBACK:
        assert nb.encode(s) is None, repr(s)
        assert tok.encode(s) == tok._encode_py(s) == jax_tok._encode_py(s)


def test_tokenize_array_takes_both_paths(tok, jax_tok, nb):
    caps = ["make it blue with short sleeves", "café"]   # fast + fallback
    arr = tokenize(caps, tokenizer=tok)
    assert arr.shape == (2, 77) and arr.dtype == np.int32
    for row, cap in zip(arr, caps):
        want = [tok.sot_id] + jax_tok._encode_py(cap) + [tok.eot_id]
        assert list(row[: len(want)]) == want and not row[len(want):].any()


def test_long_text_grows_the_buffer(tok, nb):
    s = "very " * 700 + "long caption"
    got = nb.encode(s)
    assert got == tok._encode_py(s) and len(got) > 512


def test_encode_batch_matches_per_text(tok, nb):
    """One call for the batch: each row as `encode` gives it, None exactly
    where the contract sends a row to Python (outside it, or longer than
    max_ids)."""
    texts = CAPTIONS + FALLBACK + ["make the dress red", "x " * 300]
    got = nb.encode_batch(texts, max_ids=256)
    assert len(got) == len(texts)
    for s, ids in zip(texts, got):
        if ids is None:
            assert nb.encode(s) is None or len(tok._encode_py(s)) > 256, s
        else:
            assert ids == tok._encode_py(s), repr(s)
    assert tok.encode_batch(texts) == [tok._encode_py(t) for t in texts]


@pytest.mark.parametrize("threads", [1, 4])
def test_encode_batch_threads_deterministic(tok, nb, threads):
    texts = _fuzz(3, 257, string.ascii_letters + string.digits + " '", 60)
    assert nb.encode_batch(texts, threads=threads) == [
        tok._encode_py(s) for s in texts]


def test_native_0_keeps_to_python(tok, monkeypatch):
    monkeypatch.setenv("SPN4CIR_NATIVE", "0")
    assert not native_bpe.native_available()
    assert native_bpe.get_native(synthetic_tokenizer()) is None
    monkeypatch.delenv("SPN4CIR_NATIVE")
    assert native_bpe.native_available()


def test_library_lies_under_build_native(nb):
    lib = native_bpe._lib._name
    assert lib.startswith(os.path.join(REPO, "build", "native", "bpe-"))


def test_stale_so_recovery(tmp_path):
    """A library at the expected path that lacks the batch entry point is
    rebuilt and loaded in the same process (through a unique path, since
    dlopen dedupes by path name). The child builds into a directory of its
    own, so no other process sees the stub."""
    stub_c = tmp_path / "stub.c"
    stub_c.write_text(
        "void* bpe_create(const char* a, const char* b) { return (void*)1; }\n"
        "void bpe_destroy(void* h) {}\n"
        "int bpe_encode(void* h, const char* t, int* out, int cap)"
        " { return -1; }\n")
    stub_so = tmp_path / "stub.so"
    subprocess.run(["gcc", "-shared", "-fPIC", str(stub_c), "-o",
                    str(stub_so)], check=True)
    probe = textwrap.dedent(f"""
        import shutil, sys
        from pathlib import Path
        sys.path.insert(0, {REPO!r})
        from spn4cir_tpu_torch import native
        native.BUILD_DIR = Path({str(tmp_path / "build")!r})
        from spn4cir_tpu_torch.tokenizer import native_bpe
        target = native.library_path("bpe", native_bpe._SRC,
                                     native.CXX_FLAGS + native_bpe._LINK)
        target.parent.mkdir(parents=True)
        shutil.copyfile({str(stub_so)!r}, target)
        from tests.torch_fixtures import synthetic_tokenizer
        tok = synthetic_tokenizer()
        nb = native_bpe.get_native(tok)
        assert nb is not None, native_bpe._build_error
        assert nb.encode("a blue dress") == tok._encode_py("a blue dress")
        assert nb.encode_batch(["a", "b c"]) == [tok._encode_py("a"),
                                                 tok._encode_py("b c")]
        print("RECOVERED")
    """)
    env = {k: v for k, v in os.environ.items() if k != "SPN4CIR_NATIVE"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert "RECOVERED" in out.stdout, (out.stdout, out.stderr[-2000:])
