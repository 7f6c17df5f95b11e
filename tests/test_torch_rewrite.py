"""The port's LLaMA rewriter and datagen core against the JAX package's.

The prompt contract is compared byte for byte; the sampling filters on
logits with ties at the boundary; the batch generate function at top_k=1
(greedy: one token survives the filter, so both packages' draws take it),
with weights carried over by `llama_state_dict_from_jax`. Sampled streams
cannot match across packages (torch and JAX draw different numbers from a
seed), so a seeded port run is held to itself. The triplet generators run
with stub rewriters and the same seed on both sides. The CLI writes the file
that `zscir/get_cir_data.py --llm_backend jax-tiny` writes; its random LM
weights differ between the packages, so the LLM strings are checked for
type only, every other field for equality.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.data.datasets import CIRDataset as JaxCIRDataset
from spn4cir_tpu.data.transforms import ImageTransform as JaxTransform
from spn4cir_tpu.datagen import generate as jgen
from spn4cir_tpu.datagen import llm_rewrite as jlr
from spn4cir_tpu.models import generation as jgeneration
from spn4cir_tpu.models import llama as jl
from spn4cir_tpu_torch.cli import get_cir_data
from spn4cir_tpu_torch.data.datasets import CIRDataset
from spn4cir_tpu_torch.data.transforms import ImageTransform
from spn4cir_tpu_torch.datagen import generate as tgen
from spn4cir_tpu_torch.datagen import llm_rewrite as tlr
from spn4cir_tpu_torch.datagen import templates
from spn4cir_tpu_torch.models import generation as tgeneration
from spn4cir_tpu_torch.models import llama as tl
from spn4cir_tpu_torch.models.convert import llama_state_dict_from_jax
from spn4cir_tpu_torch.tokenizer.bytelevel import ByteTokenizer
from tests.fixtures import make_cirr, make_fiq

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPTIONS = [("A red dress.", "A blue gown with long sleeves."),
            ("a dog on grass", "a cat on a sofa."),
            ("", "x."), ("Striped top: v-neck.", "plain shirt\nwith text")]


def test_prompt_blocks_are_the_jax_packages():
    for name in ("SYSTEM_PROMPT", "FIQ_CAPTION_PAIRS", "CIRR_CAPTION_PAIRS",
                 "PROMPT_TEMPLATES", "PROMPTS_REFERENCE", "PROMPTS_TARGET",
                 "PROMPTS_BOTH", "DECODE_BUCKET_BATCH"):
        assert getattr(tlr, name) == getattr(jlr, name), name
    assert templates.PROMPT_TEMPLATES == __import__(
        "spn4cir_tpu.datagen.templates", fromlist=["x"]).PROMPT_TEMPLATES


@pytest.mark.parametrize("data", ["fiq", "cirr"])
@pytest.mark.parametrize("mod_type", [0, 1])
@pytest.mark.parametrize("llm_type", [1, 2])
def test_rewrite_prompts_byte_exact(data, mod_type, llm_type):
    for c1, c2 in CAPTIONS:
        want = jlr.build_rewrite_prompt(c1, c2, data, mod_type, llm_type)
        assert tlr.build_rewrite_prompt(c1, c2, data, mod_type,
                                        llm_type) == want
        assert tlr.get_prompt(c2, data) == jlr.get_prompt(c2, data)
        assert tlr.compose_old_text(c1, c2) == jlr.compose_old_text(c1, c2)
    assert tlr.max_new_tokens_for(data) == jlr.max_new_tokens_for(data)


def test_post_process_and_rewriter_fallback():
    outs = [" new sentence: a nice dress \nextra", "plain output\nsecond",
            "a: b: c", "", "\n", "no colon at all  "]
    for o in outs:
        assert tlr.post_process(o) == jlr.post_process(o)
    for gen in (lambda p: "", lambda p: "target caption: short\nmore"):
        for c1, c2 in CAPTIONS:
            assert (tlr.make_llm_rewriter(gen, "cirr")(c1, c2)
                    == jlr.make_llm_rewriter(gen, "cirr")(c1, c2))


def test_recommended_llm_batch_matches_jax():
    for n in (1, 256, 257, 448, 449, 1800):
        for tdt, jdt in ((None, None), (torch.int8, np.int8),
                         (torch.float32, np.float32),
                         (torch.bfloat16, jnp.bfloat16)):
            assert (tlr.recommended_llm_batch(n, tdt)
                    == jlr.recommended_llm_batch(n, jdt)), (n, tdt)


def _tied_logits():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 4, (6, 40)).astype(np.float32)  # many exact ties
    x[0] = 1.0                                          # all tied
    x[1, :5] = 3.0                                      # a tied top group
    return x


@pytest.mark.parametrize("k", [1, 3, 5, 39, 40, 0])
def test_top_k_filter_keeps_boundary_ties_as_jax(k):
    x = _tied_logits()
    want = np.asarray(jgeneration.top_k_filter(jnp.asarray(x), k))
    got = tgeneration.top_k_filter(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, want)


# 1 - p stays off the multiples of 1/40, which the all-tied row's
# cumulative probabilities hit exactly: there the order of the float sums
# decides the cut, in either package
@pytest.mark.parametrize("p", [0.01, 0.33, 0.55, 0.91, 0.999])
def test_top_p_filter_cuts_by_position_as_jax(p):
    x = _tied_logits()
    want = np.asarray(jgeneration.top_p_filter(jnp.asarray(x), p))
    got = tgeneration.top_p_filter(torch.from_numpy(x), p).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got > -1e8).any(axis=-1).all()   # the top token always stays


@pytest.fixture(scope="module")
def lms():
    tok = ByteTokenizer()
    cfg = tl.LlamaConfig.tiny(vocab_size=tok.vocab_size)
    jcfg = jl.LlamaConfig.tiny(vocab_size=tok.vocab_size)
    params = jax.device_get(jl.LlamaLM(jcfg).init(
        jax.random.PRNGKey(0), input_ids=jnp.zeros((1, 4), jnp.int32))[
            "params"])
    model = tl.LlamaForCausalLM(cfg)
    model.load_state_dict(llama_state_dict_from_jax(params, cfg))
    return tok, cfg, jcfg, params, model.eval()


PROMPTS = ["a red dress", "a much longer caption about a blue gown", "shirt",
           "a striped top with sleeves and a collar", "x"]


def test_batch_generate_at_top_k_1_matches_jax(lms):
    tok, cfg, jcfg, params, model = lms
    kw = dict(max_new_tokens=6, top_k=1, seed=0, batch_size=2, len_bucket=8,
              prefill_chunk=4)
    want = jlr.make_jax_batch_generate_fn(params, jcfg, tok, **kw)(PROMPTS)
    got = tlr.make_torch_batch_generate_fn(model, cfg, tok, **kw)(PROMPTS)
    assert got == want
    single = tlr.make_torch_generate_fn(model, cfg, tok, max_new_tokens=6,
                                        top_k=1)
    assert [single(p) for p in PROMPTS] == want


def test_sampled_batch_generate_repeats_from_its_seed(lms):
    tok, cfg, _, _, model = lms

    def run(seed):
        fn = tlr.make_torch_batch_generate_fn(model, cfg, tok,
                                              max_new_tokens=8, seed=seed,
                                              batch_size=3, len_bucket=8)
        return fn(PROMPTS) + fn(PROMPTS[:2])

    a = run(5)
    assert a == run(5) and a != run(6)


def test_bucket_grouping_matches_jax(lms, monkeypatch):
    """batch_size=0: the same groups, batch sizes and left-padded masks as
    the JAX package, with a small bucket table so that the prompts straddle
    every bound."""
    tok, cfg, jcfg, params, model = lms
    table = ((4, 2, 4), (16, 3, 6), (10 ** 9, 4, 8))
    monkeypatch.setattr(jlr, "DECODE_BUCKET_BATCH", table)
    monkeypatch.setattr(tlr, "DECODE_BUCKET_BATCH", table)
    calls = {"jax": [], "torch": []}

    def stub(side, xp):
        def fake(p, cfg_, emb, *, attention_mask, max_new_tokens, eos_id,
                 **kw):
            calls[side].append(np.asarray(attention_mask).tolist())
            return xp.full((emb.shape[0], max_new_tokens), eos_id)
        return fake

    monkeypatch.setattr(jl, "llama_generate", stub("jax", jnp))
    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)
    monkeypatch.setattr(tl, "llama_generate", stub("torch", torch))
    prompts = ["ab", "cd", "efg", "longer p", "8 tokens", "h",
               "a very long prompt that lands in bucket three ok", "ij",
               "nine toks", "ten tokens"]
    kw = dict(max_new_tokens=4, top_k=1, batch_size=0, len_bucket=4)
    jlr.make_jax_batch_generate_fn(params, jcfg, tok, **kw)(prompts)
    tlr.make_torch_batch_generate_fn(model, cfg, tok, **kw)(prompts)
    assert len(calls["jax"]) >= 4 and calls["torch"] == calls["jax"]


def _triplet_world(tmp_path, kind):
    if kind == "fiq":
        root = make_fiq(str(tmp_path / "fiq"), extended=False)
        args = ("fiq", "train", "relative")
        dts = ["dress"]
        return (CIRDataset(*args, ImageTransform("targetpad", 32), root, dts),
                JaxCIRDataset(*args, JaxTransform("targetpad", 32), root, dts))
    root = make_cirr(str(tmp_path / "cirr"), extended=False)
    args = ("cirr", "train", "relative")
    return (CIRDataset(*args, ImageTransform("targetpad", 32), root),
            JaxCIRDataset(*args, JaxTransform("targetpad", 32), root))


@pytest.mark.parametrize("kind", ["fiq", "cirr"])
@pytest.mark.parametrize("batched", [False, True])
def test_extended_triplets_match_jax(tmp_path, kind, batched):
    ds, jds = _triplet_world(tmp_path, kind)
    names = list(ds.imagenames)
    name2cap = {n: f"caption of {n} number {i}." for i, n in enumerate(names)}

    def gen(prompt):
        return "new: " + prompt[-15:]

    def gen_batch(prompts):
        return [gen(p) for p in prompts]

    def rewriter(pkg):
        if batched:
            return pkg.make_llm_batch_rewriter(gen_batch, kind)
        return pkg.make_llm_rewriter(gen, kind)

    kw = dict(k=2, prompt_ids=(0, 1, 2), total_cap=7, seed=3)
    got = tgen.generate_extended_triplets(ds, name2cap,
                                          llm_rewrite=rewriter(tlr), **kw)
    want = jgen.generate_extended_triplets(jds, name2cap,
                                           llm_rewrite=rewriter(jlr), **kw)
    assert got == want and all("llm_caption" in t for t in got)
    path = tgen.write_extended_triplets(ds, got, "zs", llm=True)
    with open(path) as f:
        on_disk = json.load(f)
    assert path == jgen.write_extended_triplets(jds, want, "zs", llm=True)
    assert on_disk == json.loads(json.dumps(want))


def test_cc_triplets_match_jax(tmp_path):
    items = [{"image_id": f"http://cc/{i}", "image_path": f"/cc/img{i}.jpg",
              "caption": f"caption {i}"} for i in range(9)]
    rw = [pkg.make_llm_rewriter(lambda p: "cc: " + p[-9:], "fiq")
          for pkg in (tlr, jlr)]
    got = tgen.generate_cc_triplets(items, "fiq", k=2, total_cap=10, seed=1,
                                    llm_rewrite=rw[0])
    want = jgen.generate_cc_triplets(items, "fiq", k=2, total_cap=10,
                                     seed=1, llm_rewrite=rw[1])
    assert got == want
    legacy = {f"cc{i}": f"c {i}" for i in range(4)}
    assert (tgen.generate_cc_triplets(legacy, "cirr", k=1, seed=0)
            == jgen.generate_cc_triplets(legacy, "cirr", k=1, seed=0))
    root = str(tmp_path / "cc")
    for data in ("fiq", "cirr"):
        assert (tgen.write_cc_triplets(root, data, got)
                == jgen.write_cc_triplets(root, data, want))


def test_cli_writes_the_file_of_the_jax_cli(tmp_path):
    root = make_cirr(str(tmp_path / "cirr"), extended=False)
    names = sorted({n for n in os.listdir(os.path.join(root, "dev"))})
    it = tmp_path / "it.json"
    it.write_text(json.dumps([
        {"image_id": n[:-4], "caption": f"a photo of thing {i}."}
        for i, n in enumerate(names)]))
    common = ["--dataset", "cirr", "--data_path", root, "--it_list", str(it),
              "--use_llm", "1", "--llm_batch", "8", "--k", "1"]
    jax_run = subprocess.run(
        [sys.executable, os.path.join(REPO, "zscir", "get_cir_data.py"),
         *common, "--llm_backend", "jax-tiny"],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert jax_run.returncode == 0, jax_run.stderr[-2000:]
    path = os.path.join(root, "cirr", "captions",
                        "cap.rc2.train.extend_zs_llm.json")
    with open(path) as f:
        want = json.load(f)
    os.remove(path)
    assert get_cir_data.main(
        [*common, "--llm_backend", "torch-tiny", "--device", "cpu"]) == path
    with open(path) as f:
        got = json.load(f)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert isinstance(g["llm_caption"], str)
        assert ({k: v for k, v in g.items() if k != "llm_caption"}
                == {k: v for k, v in w.items() if k != "llm_caption"})


@pytest.mark.parametrize("extra,message", [
    (["--llm_tokenizer", "some/dir"], "not yet ported"),
    (["--mesh_model", "2"], "multi-process launch")])
def test_cli_refuses_what_is_not_ported(tmp_path, extra, message):
    root = make_cirr(str(tmp_path / "cirr"), extended=False)
    it = tmp_path / "it.json"
    it.write_text("[]")
    with pytest.raises(SystemExit, match=message):
        get_cir_data.main(["--dataset", "cirr", "--data_path", root,
                           "--it_list", str(it), "--use_llm", "1",
                           "--device", "cpu", *extra])


def test_load_torch_rewriter_refuses_random_7b_weights():
    with pytest.raises(ValueError, match="ckpt_path"):
        tlr.load_torch_rewriter(tokenizer=ByteTokenizer(), device="cpu")
    with pytest.raises(ValueError, match="tokenizer"):
        tlr.load_torch_rewriter(device="cpu")
    rw = tlr.load_torch_rewriter(tiny=True, data="cirr", device="cpu",
                                 batch_size=2)
    assert isinstance(rw("a dog.", "a cat."), str)
