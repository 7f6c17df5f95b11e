"""LLM rewriting of template-composed modification texts.

Counterpart of `spn4cir_tpu/datagen/llm_rewrite.py`. Parity target:
`zscir/llama_generate.py:29-96` (LLaMA-2-7b-chat pipeline) with the few-shot
chat prompts of `zscir/prompt.py:41-115` and the plain rewrite templates of
`zscir/prompt.py:1-16`. The prompt blocks below are the reference's *data
contract*: generated `_llm` captions only match the reference's
distribution if the prompts match verbatim, so they are reproduced exactly
(content, ordering, whitespace).

The LM is a pluggable text-generation callable; `make_torch_generate_fn` /
`make_torch_batch_generate_fn` run the port's LLaMA decoder
(`models/llama.py`) on the card, and `load_torch_rewriter` composes the
whole rewriter from a checkpoint (or, tiny only, random weights).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

# Per-bucket decode batch for the 7B LM: (padded prompt length upper bound,
# batch at a float KV cache, batch at an int8 KV cache). These are the JAX
# package's working points, copied as they are and not re-derived on the
# H100 (ROADMAP). `make_torch_batch_generate_fn(batch_size=0)` partitions
# prompts by token length at these bounds and batches each partition at its
# bucket's point.
DECODE_BUCKET_BATCH = ((256, 32, 32), (448, 16, 32), (10 ** 9, 16, 32))


def recommended_llm_batch(prompt_tokens: int, cache_dtype=None) -> int:
    """The per-bucket --llm_batch default for a prompt of this many tokens
    (see DECODE_BUCKET_BATCH). `cache_dtype=None` means the 7B default
    (bf16); a float32 cache halves the float working point (the same
    memory arithmetic at twice the bytes)."""
    itemsize = 2
    if cache_dtype is not None:
        itemsize = torch.empty((), dtype=cache_dtype).element_size()
    for bound, float_b, int8_b in DECODE_BUCKET_BATCH:
        if prompt_tokens <= bound:
            if itemsize == 1:
                return int8_b
            return max(1, float_b // 2) if itemsize >= 4 else float_b
    return DECODE_BUCKET_BATCH[-1][1 if itemsize != 1 else 2]


# --- zscir/prompt.py:1-16 — llm_type 2 plain rewrite templates -------------

_REWRITE_TEMPLATE = (
    "Rewrite the sentence to maintain the original meaning while reducing "
    "grammatical errors and increasing the variety of expression\n"
    "Remember only output the new sentence without other additional words.\n"
    "sentence:{0}\n"
    "new sentence:\n"
)

PROMPT_TEMPLATES = {
    "fiq": _REWRITE_TEMPLATE,
    "cirr": _REWRITE_TEMPLATE,
}

# --- zscir/prompt.py:35-40 — llm_type 1 system prompt ----------------------

SYSTEM_PROMPT = """You are a researcher tasked with rewrite source sentence to mimic target sentence while trying to keep the original meaning.  
Please ensure that your responses are close to the style of the target sentences in the examples.
If you encounter harmful words, please change them to harmless content.
Remember only output the new sentence without other additional words.
Output answer in one string
"""

# --- zscir/prompt.py:44-66 — FIQ few-shot source/target pairs --------------

FIQ_CAPTION_PAIRS = [
    {
        "source": "The dress is a sleeveless, black, fitted, and stylish dress",
        "target": "is solid black with no sleeves",
    },
    {
        "source": "Red, flowy, short, sequined, and elegant.",
        "target": "is red and flowy",
    },
    {
        "source": "Obama Mama shirt, black color.",
        "target": "has the words Obama Mama on front",
    },
    {
        "source": "Striped, black and white, sleeveless, fitted, and stylish.",
        "target": "has sleeveless black and white stripes",
    },
    {
        "source": "Colorful striped top with a v-neck.",
        "target": "Has stripes.",
    },
]

# --- zscir/prompt.py:78-101 — CIRR few-shot source/target pairs ------------

CIRR_CAPTION_PAIRS = [
    {
        "source": "A large, brown dog with a black nose is sitting on the grass, looking up instead of A cute baby panda is being held by a person in a zoo",
        "target": "Dog in grass instead of a panda.",
    },
    {
        "source": "A street with several blue buildings, including churches, and a park with trees and bushes instead of A large, old stone church with a tower and a wall, surrounded by a grassy field and a dirt road",
        "target": "instead of an old fortress with a rampart, an Orthodox church with a courtyard.",
    },
    {
        "source": "A colorful parrot is standing on a perch in a cage instead of Two parrots are sitting on a branch, sharing a piece of fruit",
        "target": "Remove one of the parrots.",
    },
    {
        "source": "Two colorful parrots are kissing on a branch instead of A colorful parrot is perched on a tree branch, looking at the camera.",
        "target": "two birds, facing each other.",
    },
    {
        "source": "A monkey is standing on a grassy field, looking at the camera instead of A group of monkeys is sitting on the ground, with some of them touching each other.",
        "target": "I want the pic to show just one monkey.",
    },
]


def _few_shot_prompt(caption: str, pairs: Sequence[dict]) -> str:
    """LLaMA-2 chat formatting exactly as zscir/prompt.py:42-73 builds it
    (first shot carries the <<SYS>> block; note the reference's asymmetric
    'caption:' vs ' target caption:' spacing in the final turn)."""
    prompt = f"""<s>[INST] <<SYS>>\n{SYSTEM_PROMPT}<</SYS>>\n\n"""
    for i, pair in enumerate(pairs):
        if i == 0:
            prompt += (f"source caption: {pair['source']}\n"
                       f"target caption: [/INST]{pair['target']} </s>")
        else:
            prompt += (f"<s>[INST]source caption: {pair['source']}\n"
                       f"target caption: [/INST]{pair['target']} </s>")
    prompt += f"<s>[INST]source caption: {caption}\n target caption: [/INST]"
    return prompt


def get_fiq_prompt(caption: str) -> str:
    return _few_shot_prompt(caption, FIQ_CAPTION_PAIRS)


def get_cirr_prompt(caption: str) -> str:
    return _few_shot_prompt(caption, CIRR_CAPTION_PAIRS)


def get_prompt(caption: str, data: str = "fiq") -> str:
    """zscir/prompt.py:118-122."""
    if data == "fiq":
        return get_fiq_prompt(caption)
    return get_cirr_prompt(caption)


def post_process(output: str) -> str:
    """zscir/llama_generate.py:47-52: strip, keep text after the last ':',
    truncate at the first newline."""
    res = output.strip()
    if ":" in output:
        res = res.split(":")[-1]
    res = res.split("\n")[0]
    return res


def compose_old_text(caption1: str, caption2: str) -> str:
    """mod_type 0 composition (zscir/llama_generate.py:79-84): strip one
    trailing period from each caption, then '{1} instead of {0}'."""
    if caption1 and caption1[-1] == ".":
        caption1 = caption1[:-1]
    if caption2 and caption2[-1] == ".":
        caption2 = caption2[:-1]
    return "{1} instead of {0}".format(caption1, caption2)


def build_rewrite_prompt(caption1: str, caption2: str, data: str = "fiq",
                         mod_type: int = 0, llm_type: int = 1) -> str:
    """Full prompt for one rewrite, mirroring generate_modified_text
    (zscir/llama_generate.py:73-93): llm_type 1 -> few-shot chat prompt,
    otherwise the plain rewrite template."""
    old_text = compose_old_text(caption1, caption2) if mod_type == 0 else caption2
    if llm_type == 1:
        return get_prompt(old_text, data)
    return PROMPT_TEMPLATES[data].format(old_text)


def max_new_tokens_for(data: str) -> int:
    """zscir/llama_generate.py:94: 25 for FIQ, 50 otherwise."""
    return 25 if data == "fiq" else 50


def make_llm_rewriter(generate_fn: Callable[[str], str], data: str = "fiq",
                      mod_type: int = 0, llm_type: int = 1,
                      ) -> Callable[[str, str], str]:
    """Wrap a text-generation callable into the (caption1, caption2) ->
    llm_caption signature `generate_extended_triplets` expects. The callable
    receives the full prompt and must return only the continuation (the
    reference pipeline slices off the prompt echo, llama_generate.py:65-66);
    output goes through the reference's post_process."""

    def rewrite(caption1: str, caption2: str) -> str:
        prompt = build_rewrite_prompt(caption1, caption2, data, mod_type, llm_type)
        res = post_process(generate_fn(prompt))
        return res if res else caption2

    return rewrite


# --- zscir/prompts.py:1-66 — CC paraphrase prompt banks --------------------
# (kept verbatim for the CC3M out-of-domain triplet path; the reference
# prints their lengths at import, we only expose the lists.)

PROMPTS_REFERENCE = [
    "remove {0}",
    "{0} is removed",
]

PROMPTS_TARGET = [
    "{1}",
    "apply {1}",
    "add {1}",
    "if it is {1}",
    "{1} is the new option",
    "choose {1} instead",
    "{1} is the updated version",
    "use {1} from now on",
    "{1} is the new choice",
    "opt for {1}",
    "{1} is the updated option",
    "{1} is the new selection",
    "{1} is the new option available",
    "{1} is the updated choice",
    "{1} is introduced as the new option after",
]

PROMPTS_BOTH = [
    "I want an image of {1} instead of an image of {0}",
    "change {0} to {1}",
    "Replace the image of {0} with {1} in the output.",
    "Generate an output image where {1} is depicted instead of {0}.",
    "Transform the input image to show {1} instead of {0}.",
    "Obtain an image with {1} replacing {0} from the input.",
    "Produce an output image featuring {1} rather than {0}.",
    "Modify the input image to display {1} instead of {0}.",
    "Create a new image by substituting {0} for {1} in the original.",
    "Request an image of {1} as a replacement for {0}.",
    "replace {0} with {1}",
    "substitute {1} for {0}",
    "exchange {0} with {1}",
    "alter {0} to {1}",
    "convert {0} to {1}",
    "transform {0} into {1}",
    "swap {0} for {1}",
    "replace {0} with {1}",
    "remodel {0} into {1}",
    "redesign {0} as {1}",
    "update {0} to {1}",
    "revamp {0} into {1}",
    "substitute {1} for {0}",
    "modify {0} to become {1}",
    "turn {0} into {1}",
    "alter {0} to match {1}",
    "customize {0} to become {1}",
    "adapt {0} to fit {1}",
    "upgrade {0} to {1}",
    "change {0} to match {1}",
    "tweak {0} to become {1}",
    "amend {0} to fit {1}",
    "{0} is replaced with {1}",
    "{0} is removed and {1} is added",
    "{1} is introduced after {0} is removed",
    "{0} is removed and {1} takes its place",
    "{1} is added after {0} is removed",
    "{0} is removed and {1} is introduced",
    "{1} is added in place of {0}",
    "{1} is introduced after {0} is retired",
    "{1} is added as a replacement for {0}",
]


def _continuation(ids: Sequence[int], eos: int, tokenizer) -> str:
    """The decoded tokens before the first EOS."""
    toks = []
    for t in ids:
        if t == eos:
            break
        toks.append(t)
    return tokenizer.decode(toks)


def _generate_kwargs(max_new_tokens, top_k, cache_dtype, prefill_chunk,
                     attn_kernel) -> dict:
    """The reference's sampling (zscir/llama_generate.py:55-63: do_sample,
    top_k=10, HF-default temperature and top_p of 1.0)."""
    kw = dict(max_new_tokens=max_new_tokens, do_sample=True,
              temperature=1.0, top_p=1.0, top_k=top_k,
              prefill_chunk=prefill_chunk, attn_kernel=attn_kernel)
    if cache_dtype is not None:
        kw["cache_dtype"] = cache_dtype
    return kw


def make_torch_generate_fn(params, cfg, tokenizer, *,
                           max_new_tokens: int = 25, top_k: int = 10,
                           seed: int = 0, cache_dtype=None,
                           prefill_chunk: Optional[int] = None,
                           attn_kernel: Optional[bool] = None):
    """The port's LLaMA decoder (models/llama.py) as a `generate(prompt) ->
    continuation` callable for `make_llm_rewriter`: one prompt per
    `llama_generate` call, on the device of `params`, sampled from one
    generator of that device seeded with `seed` that every call advances
    (eos doubles as pad)."""
    from spn4cir_tpu_torch.models.llama import (embed_tokens, llama_generate,
                                                params_device)

    eos = tokenizer.eos_token_id
    device = params_device(params)
    generator = torch.Generator(device=device).manual_seed(seed)
    kw = _generate_kwargs(max_new_tokens, top_k, cache_dtype, prefill_chunk,
                          attn_kernel)

    def generate(prompt: str) -> str:
        ids = torch.tensor(tokenizer.encode(prompt), device=device)
        out = llama_generate(params, cfg, embed_tokens(params, ids)[None],
                             eos_id=eos, pad_id=eos, generator=generator,
                             **kw)
        return _continuation(out[0].tolist(), eos, tokenizer)

    return generate


def make_torch_batch_generate_fn(params, cfg, tokenizer, *,
                                 max_new_tokens: int = 25, top_k: int = 10,
                                 seed: int = 0, batch_size: int = 8,
                                 len_bucket: int = 32, cache_dtype=None,
                                 prefill_chunk: Optional[int] = None,
                                 attn_kernel: Optional[bool] = None):
    """Batched rewriting: many prompts per `llama_generate` call, grouped as
    the JAX package's `make_jax_batch_generate_fn` groups them, so the card
    runs the batches the JAX package would.

    Prompts are sorted by token length, grouped `batch_size` at a time and
    LEFT-padded to the next `len_bucket` multiple; a short group repeats its
    last row up to the batch size (outputs discarded), and a lone prompt
    runs at B=1. `batch_size=0` partitions by DECODE_BUCKET_BATCH and runs
    each partition at its bucket's batch. One generator of the device,
    seeded with `seed`, is advanced by every call (the JAX package splits a
    key per call).

    Returns `generate_batch(prompts) -> continuations` (order-preserving).
    """
    import numpy as np

    from spn4cir_tpu_torch.models.llama import (embed_tokens, llama_generate,
                                                params_device)

    eos = tokenizer.eos_token_id
    device = params_device(params)
    generator = torch.Generator(device=device).manual_seed(seed)
    kw = _generate_kwargs(max_new_tokens, top_k, cache_dtype, prefill_chunk,
                          attn_kernel)

    def _groups(order, enc):
        if batch_size:
            return [(order[lo:lo + batch_size], batch_size)
                    for lo in range(0, len(order), batch_size)]
        groups, i = [], 0
        while i < len(order):
            first_len = len(enc[order[i]])
            bound = next(bd for bd, _, _ in DECODE_BUCKET_BATCH
                         if first_len <= bd)
            bb = recommended_llm_batch(first_len, cache_dtype)
            g = []
            while (i < len(order) and len(g) < bb
                   and len(enc[order[i]]) <= bound):
                g.append(order[i])
                i += 1
            groups.append((g, bb))
        return groups

    def generate_batch(prompts: Sequence[str]) -> list:
        enc = [tokenizer.encode(p) for p in prompts]
        order = sorted(range(len(enc)), key=lambda i: len(enc[i]))
        results = [""] * len(enc)
        for idxs, group_batch in _groups(order, enc):
            longest = max(len(enc[i]) for i in idxs)
            plen = -(-longest // len_bucket) * len_bucket
            bs = group_batch if len(idxs) > 1 else 1
            rows = idxs + [idxs[-1]] * (bs - len(idxs))
            ids = np.full((bs, plen), eos, np.int64)
            mask = np.zeros((bs, plen), np.int64)
            for r, i in enumerate(rows):
                ids[r, plen - len(enc[i]):] = enc[i]
                mask[r, plen - len(enc[i]):] = 1
            out = llama_generate(
                params, cfg,
                embed_tokens(params, torch.from_numpy(ids).to(device)),
                eos_id=eos, pad_id=eos, generator=generator,
                attention_mask=torch.from_numpy(mask).to(device), **kw)
            out = out.cpu().tolist()
            for r, i in enumerate(idxs):
                results[i] = _continuation(out[r], eos, tokenizer)
        return results

    return generate_batch


def make_llm_batch_rewriter(generate_batch_fn, data: str = "fiq",
                            mod_type: int = 0, llm_type: int = 1):
    """Batched counterpart of `make_llm_rewriter`: the returned callable has
    the same (caption1, caption2) -> llm_caption signature, plus a
    `.rewrite_batch(pairs)` method that `generate_extended_triplets` uses to
    rewrite the whole triplet list in large device batches."""

    def rewrite_batch(pairs: Sequence[tuple]) -> list:
        prompts = [build_rewrite_prompt(c1, c2, data, mod_type, llm_type)
                   for c1, c2 in pairs]
        outs = generate_batch_fn(prompts)
        return [post_process(o) or c2 for o, (c1, c2) in zip(outs, pairs)]

    def rewrite(caption1: str, caption2: str) -> str:
        return rewrite_batch([(caption1, caption2)])[0]

    rewrite.rewrite_batch = rewrite_batch
    return rewrite


def load_torch_rewriter(ckpt_path: str = "", tokenizer=None, *,
                        data: str = "fiq", mod_type: int = 0,
                        llm_type: int = 1, tiny: bool = False, seed: int = 0,
                        quantize_weights: bool = False, batch_size: int = 1,
                        cache_dtype=None, prefill_chunk: Optional[int] = None,
                        attn_kernel: Optional[bool] = None,
                        device: str = "0", mesh=None):
    """The rewriter end to end: the port's LLaMA-2 decoder and the
    byte-exact prompt contract, on `device` (`cli.common.resolve_device`:
    "N" is cuda:N, the default cuda:0; "cpu" the CPU).

    `ckpt_path` is an HF LlamaForCausalLM state dict (torch), loaded in
    bf16 at 7B and float32 at tiny; empty means random weights, which only
    `tiny` takes (a random 7B would write nonsense rewrites into the
    dataset). `tokenizer` defaults to the byte-level one when `tiny`. The
    7B's cache defaults to bf16, the tiny one's to float32.
    `quantize_weights` makes the matmul weights int8. `batch_size != 1`
    rewrites in left-padded device batches (0 = by DECODE_BUCKET_BATCH).
    `mesh` (`parallel.tp.make_model_mesh`) makes the LM tensor-parallel:
    this rank keeps its slice (`parallel.tp.shard_llama_params`), its KV
    cache holds its kv heads, and every rank of the group must rewrite the
    same captions in the same order (the sampling generators are seeded
    alike and see the same gathered logits)."""
    from spn4cir_tpu_torch.cli.common import resolve_device
    from spn4cir_tpu_torch.models.convert import load_llama_checkpoint
    from spn4cir_tpu_torch.models.llama import (LlamaConfig,
                                                LlamaForCausalLM,
                                                quantize_llama_weights)

    dev = resolve_device(device)
    if tokenizer is None:
        if not tiny:
            raise ValueError("load_torch_rewriter needs a tokenizer for "
                             "non-tiny configs")
        from spn4cir_tpu_torch.tokenizer.bytelevel import ByteTokenizer
        tokenizer = ByteTokenizer()
    cfg = (LlamaConfig.tiny(vocab_size=max(
               int(getattr(tokenizer, "vocab_size", 128)), 128))
           if tiny else LlamaConfig.llama2_7b_chat())
    if not ckpt_path and not tiny:
        raise ValueError("load_torch_rewriter needs ckpt_path for non-tiny "
                         "configs (random weights would produce nonsense "
                         "rewrites)")
    model = LlamaForCausalLM(cfg, device="meta",
                             dtype=torch.float32 if tiny else torch.bfloat16)
    model.to_empty(device=dev)
    if ckpt_path:
        model.load_state_dict(load_llama_checkpoint(ckpt_path, cfg))
    else:
        model.init_weights(torch.Generator(device=dev).manual_seed(0))
    model.eval()
    params = quantize_llama_weights(model) if quantize_weights else model
    if mesh is not None:
        from spn4cir_tpu_torch.parallel.tp import shard_llama_params

        params, cfg = shard_llama_params(params, cfg, mesh)
        del model
    if cache_dtype is None and not tiny:
        cache_dtype = torch.bfloat16
    if batch_size != 1:  # 0 = bucket-aware auto, >1 = fixed device batches
        gen = make_torch_batch_generate_fn(
            params, cfg, tokenizer, max_new_tokens=max_new_tokens_for(data),
            seed=seed, batch_size=batch_size, cache_dtype=cache_dtype,
            prefill_chunk=prefill_chunk, attn_kernel=attn_kernel)
        return make_llm_batch_rewriter(gen, data, mod_type, llm_type)
    gen = make_torch_generate_fn(params, cfg, tokenizer,
                                 max_new_tokens=max_new_tokens_for(data),
                                 seed=seed, cache_dtype=cache_dtype,
                                 prefill_chunk=prefill_chunk,
                                 attn_kernel=attn_kernel)
    return make_llm_rewriter(gen, data, mod_type, llm_type)
