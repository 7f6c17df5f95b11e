"""The MLLM captioning stage of the datagen pipeline.

Counterpart of `spn4cir_tpu/datagen/captioner.py` (reference
`zscir/captioner_llava.py` / `zscir/captioner_blip.py`): caption every train
image with an MLLM ("please briefly describe the {category} in {k}
words"), writing `mm_data/{ds}/..._it_{mllm}_{k}.json` entries of the form
{"image_id": name, "caption": text}, the it-list that `cli.get_cir_data`
reads.

`make_llava_captioner` (the canonical path) and `make_blip_captioner` build
the port's captioners (`models/llava.py`, `models/blip_caption.py`) on one
device and return `(captioner, transform, batched_fn)`; `batched_fn`
captions a list of preprocessed (H, W, 3) arrays in fixed-size batches,
the last one padded with its last image. `caption_images_batched` appends
every finished batch to a jsonl sidecar (fsynced) so that a killed run
resumes without decoding what it already captioned
(`load_caption_checkpoint` tolerates a torn last line). `stub_captioner` is
the model-free fallback.

`make_llava_captioner(mesh=)` runs the tensor-parallel LLaVA: every rank
of the mesh's model group holds its slice (`models.llava.LlavaCaptioner`).
`make_llava_captioner(llava_lm="moonlight-16b-a3b")` puts Moonlight-16B-A3B
(DeepSeek-V3, `models/deepseek_v3.py`) in LLaVA's LM slot, on one device;
`llava_lm="kimi-linear-48b-a3b"` puts Kimi-Linear-48B-A3B there, with one
device's share of its experts (`LlavaConfig.kimi_linear`).
Not yet ported, and refused: an HF tokenizer (`tokenizer_path=`, it needs
`transformers`).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

CAPTION_PROMPT = "please briefly describe the {category} in {num_words} words"

#: the language models of the LLaVA captioner (`make_llava_captioner`):
#: name -> (its `LlavaConfig` constructor at full width, the family of its
#: tiny preset, images a batch at full width, 0 for `recommended_llm_batch`).
#: Moonlight's 31.9 GB of bf16 weights leave the card room for 128 rows of
#: prefill (the benchmark's caption cell); with 64 of Kimi-Linear's 256
#: experts a layer (28.8 GB of bf16 weights), 256 rows hold 10.7 GB of KDA
#: state and leave room for their prefill (the benchmark's
#: `llava-kimi-linear-48b-a3b.caption-b256` cell)
LLAVA_LMS = {"llama-7b": ("v1_7b", "llama", 0),
             "moonlight-16b-a3b": ("moonlight", "deepseek", 128),
             "kimi-linear-48b-a3b": ("kimi_linear", "kimi", 256)}


def caption_prompt(category: str, num_words: int = 10) -> str:
    """The reference's instruction template (ref captioner_llava.py:32-62)."""
    return CAPTION_PROMPT.format(category=category, num_words=num_words)


def caption_images(
    names_and_images: Iterable,
    caption_fn: Callable[[np.ndarray, str], str],
    category: str = "image",
    num_words: int = 10,
) -> List[dict]:
    """Run `caption_fn(image, prompt)` over (name, image) pairs -> it-list."""
    prompt = caption_prompt(category, num_words)
    return [{"image_id": name, "caption": caption_fn(image, prompt)}
            for name, image in names_and_images]


def write_it_list(it_list: List[dict], data_name: str, mllm: str,
                  word_num: int, out_root: str = "mm_data",
                  prefix: Optional[str] = None,
                  filename: Optional[str] = None) -> str:
    """The reference's file name, mm_data/{ds}/{ds}_it_{mllm}_{k}.json
    (ref captioner_llava.py:173-205, get_cir_data.py:35,110); `filename`
    overrides it for the CC shards, mm_data/zs/cc_it_{id}_{mllm}_{k}.json
    (captioner_llava.py:204)."""
    prefix = prefix or {"fiq": "fashioniq", "cirr": "cirr"}.get(data_name,
                                                                data_name)
    folder = os.path.join(out_root, data_name)
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(
        folder, filename or f"{prefix}_it_{mllm}_{word_num}.json")
    with open(path, "w") as f:
        json.dump(it_list, f)
    return path


def load_cc_shard(path: str) -> List[dict]:
    """A CC3M shard (`part_{id}.data`, one JSON per line: url, image path,
    per-language captions; ref data_process.py:42-54 get_cc_it) -> it-list
    entries {"image_id": url, "image_path": path, "caption": en}."""
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            out.append({"image_id": d["url"], "image_path": d["image"],
                        "caption": d["caption"]["en"]})
    return out


def _batches(images: List[np.ndarray], batch_size: int):
    """Fixed-size batches of `images`, the last padded with its last image:
    (the stacked batch, its number of real images)."""
    for lo in range(0, len(images), batch_size):
        chunk = list(images[lo: lo + batch_size])
        pad = batch_size - len(chunk)
        yield np.stack(chunk + [chunk[-1]] * pad), len(chunk)


def make_blip_captioner(params=None, *, blip_size: str = "base",
                        bert_vocab_path: Optional[str] = None,
                        use_nucleus_sampling: bool = False,
                        num_beams: int = 3, max_length: int = 30,
                        min_length: int = 10, batch_size: int = 32,
                        device: str = "0"):
    """The BLIP captioner (ViT + MED LM decoder, models/blip_caption.py),
    the reference's `blip` path (zscir/captioner_blip.py:35-37 loading
    LAVIS "blip_caption"; generation defaults blip_caption.py:136-145), on
    `device` ("N" is cuda:N, the default cuda:0; "cpu" the CPU).

    `params`: a LAVIS blip_caption checkpoint path, a state dict, or
    None / "" for random weights from seed 0 (smoke runs; the captions are
    noise). Returns (captioner, transform, batched_fn): `batched_fn(images,
    generator=None)` captions a list of preprocessed arrays in batches of
    `batch_size`; `transform` is the LAVIS eval preprocess (square bicubic
    resize + CLIP normalize)."""
    from spn4cir_tpu_torch.cli.common import resolve_device
    from spn4cir_tpu_torch.data.transforms import ImageTransform
    from spn4cir_tpu_torch.models.blip_caption import BlipCaptioner
    from spn4cir_tpu_torch.models.convert import load_blip_caption_checkpoint

    dev = resolve_device(device) if isinstance(device, str) else device
    cap = BlipCaptioner(blip_size=blip_size, bert_vocab_path=bert_vocab_path,
                        device=dev)
    transform = ImageTransform("blip_eval", cap.input_dim)
    if params is None or params == "":
        cap.init_params(torch.Generator().manual_seed(0))
    else:
        if isinstance(params, str):
            params = load_blip_caption_checkpoint(
                params, num_tokens=cap.vit_cfg.num_tokens)
        cap.model.load_state_dict(params)

    def batched_fn(images: List[np.ndarray],
                   generator: Optional[torch.Generator] = None) -> List[str]:
        if use_nucleus_sampling and generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        out: List[str] = []
        for batch, n in _batches(images, batch_size):
            caps = cap.caption(batch,
                               use_nucleus_sampling=use_nucleus_sampling,
                               num_beams=num_beams, max_length=max_length,
                               min_length=min_length, generator=generator)
            out.extend(caps[:n])
        return out

    return cap, transform, batched_fn


def make_llava_captioner(params=None, *, tokenizer=None,
                         tokenizer_path: str = "", llava_size: str = "7b",
                         category: str = "image", word_num: int = 10,
                         max_new_tokens: int = 64, batch_size: int = 0,
                         dtype: Optional[torch.dtype] = None,
                         quantize_weights: bool = False, mesh=None,
                         cache_dtype=None, attn_kernel=None,
                         llava_lm: str = "llama-7b", device: str = "0"):
    """The reference's canonical captioning path, LLaVA-v1
    (zscir/captioner_llava.py:147-205 captions every published dataset with
    it): the CLIP ViT-L/14 tower + LLaMA-7B of models/llava.py, on `device`.

    `params`: an HF LlavaLlamaForCausalLM checkpoint path, a state dict, or
    None / "" for random weights from seed 0 (smoke runs). `tokenizer`: an
    object with encode / decode / bos_token_id / eos_token_id, taken as
    given; at `llava_size="tiny"` the byte tokenizer is the default. The
    weights are bf16 at 7B and float32 at tiny unless `dtype` says
    otherwise. Sampling is the reference's: T=0.01, top_p=0.01.
    `quantize_weights` makes the LM's matmul weights int8; their products
    still dequantize after the matmul (kernel #12 off, as in the JAX
    captioner). `batch_size=0` takes `recommended_llm_batch(448,
    cache_dtype)` at 7B (the llava_v1 prompt plus 64 new tokens fits the
    448 bucket), LLAVA_LMS's batch with Moonlight or Kimi-Linear and 2 at
    tiny. `mesh`
    (`parallel.tp.make_model_mesh`): the tensor-parallel model; every rank
    makes the same calls.

    `llava_lm`: "llama-7b" (LLaVA-v1's LM, the default),
    "moonlight-16b-a3b" (Moonlight-16B-A3B's DeepSeek-V3 decoder at its
    published widths, bf16, one device; neither `quantize_weights` nor
    `mesh`) or "kimi-linear-48b-a3b" (Kimi-Linear-48B-A3B at its published
    widths with 64 of each layer's 256 experts, one device's share of a
    four-way expert-parallel deployment; likewise). Their published
    tiktoken vocabulary is not in the repository: without `tokenizer` they
    run the byte tokenizer, whose ids lie inside their 163,840. With
    `llava_size="tiny"` the LM is the tiny preset of the chosen family.

    Returns (captioner, transform, batched_fn) like make_blip_captioner;
    `batched_fn(images, generator=None, prompt=None)` takes a prompt that
    overrides the default one, so that one loaded model serves every
    dress type's prompt."""
    if tokenizer_path:
        raise SystemExit("tokenizer_path is not yet ported to PyTorch (an HF "
                         "LLaMA tokenizer needs transformers); pass "
                         "tokenizer=")
    from spn4cir_tpu_torch.cli.common import resolve_device
    from spn4cir_tpu_torch.data.transforms import ImageTransform
    from spn4cir_tpu_torch.models.convert import load_llava_checkpoint
    from spn4cir_tpu_torch.models.llava import LlavaCaptioner, LlavaConfig

    if llava_lm not in LLAVA_LMS:
        raise ValueError(f"llava_lm must be one of {tuple(LLAVA_LMS)}, not "
                         f"{llava_lm!r}")
    full, family, full_batch = LLAVA_LMS[llava_lm]
    tiny = llava_size == "tiny"
    if tokenizer is None:
        if not tiny and family == "llama":
            raise ValueError("make_llava_captioner needs tokenizer= (the "
                             "LLaMA sentencepiece assets are not in the "
                             "repository)")
        from spn4cir_tpu_torch.tokenizer.bytelevel import ByteTokenizer
        tokenizer = ByteTokenizer()
    if tiny:
        cfg = LlavaConfig.tiny(
            vocab_size=max(int(getattr(tokenizer, "vocab_size", 128)), 128),
            lm=family)
    else:
        cfg = getattr(LlavaConfig, full)()
    if dtype is None:
        dtype = torch.float32 if tiny else torch.bfloat16
    dev = resolve_device(device) if isinstance(device, str) else device
    cap = LlavaCaptioner(cfg, tokenizer, dtype=dtype, device=dev, mesh=mesh)
    transform = ImageTransform("clip", cfg.vision.image_size)
    if params is None or params == "":
        cap.init_params(torch.Generator(device=dev).manual_seed(0))
    else:
        if isinstance(params, str):
            params = load_llava_checkpoint(params, cfg)
        cap.model.load_state_dict(params)
    if quantize_weights:
        cap.quantize()
    if batch_size == 0:
        batch_size = 2 if tiny else full_batch
    if batch_size == 0:
        from spn4cir_tpu_torch.datagen.llm_rewrite import recommended_llm_batch
        batch_size = recommended_llm_batch(448, cache_dtype)

    default_prompt = caption_prompt(category, word_num)

    def batched_fn(images: List[np.ndarray],
                   generator: Optional[torch.Generator] = None,
                   prompt: Optional[str] = None) -> List[str]:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        out: List[str] = []
        for batch, n in _batches(images, batch_size):
            caps = cap.caption(batch, prompt or default_prompt,
                               max_new_tokens=max_new_tokens,
                               generator=generator, cache_dtype=cache_dtype,
                               attn_kernel=attn_kernel)
            out.extend(caps[:n])
        return out

    return cap, transform, batched_fn


def load_caption_checkpoint(path: str) -> Dict[str, str]:
    """The partial-progress sidecar (one JSON per line: {"image_id",
    "caption"}) -> {image_id: caption}. A torn last line (the process died
    mid-write) is skipped."""
    done: Dict[str, str] = {}
    if not path or not os.path.exists(path):
        return done
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail from a kill mid-write
            done[d["image_id"]] = d["caption"]
    return done


def caption_images_batched(names_and_images: Iterable, batched_fn,
                           batch_size: int = 32,
                           checkpoint_path: str = "",
                           already: Optional[Dict[str, str]] = None
                           ) -> List[dict]:
    """The batched it-list builder (same output as `caption_images`).

    With `checkpoint_path`, every finished batch is appended to a jsonl
    sidecar and fsynced at once; `already` (from `load_caption_checkpoint`)
    seeds the output. Pass it AND filter the input by its keys, so that
    skipped images are never decoded. A sidecar that ends in a torn line
    gets a newline before the first new entry (the JAX package appends to
    the torn line, and the next resume loses that entry)."""
    it_list = [{"image_id": n, "caption": c}
               for n, c in (already or {}).items()]
    ckpt = open(checkpoint_path, "a+") if checkpoint_path else None
    if ckpt is not None and ckpt.tell():
        # a torn last line (a kill mid-write) must not swallow the first
        # new entry: start it on a line of its own
        ckpt.seek(ckpt.tell() - 1)
        if ckpt.read(1) != "\n":
            ckpt.write("\n")

    def flush(names, images):
        for n, c in zip(names, batched_fn(images)):
            entry = {"image_id": n, "caption": c}
            it_list.append(entry)
            if ckpt is not None:
                ckpt.write(json.dumps(entry) + "\n")
        if ckpt is not None:
            ckpt.flush()
            os.fsync(ckpt.fileno())

    names, images = [], []
    try:
        for name, image in names_and_images:
            names.append(name)
            images.append(np.asarray(image))
            if len(images) == batch_size:
                flush(names, images)
                names, images = [], []
        if images:
            flush(names, images)
    finally:
        if ckpt is not None:
            ckpt.close()
    return it_list


def stub_captioner(image: np.ndarray, prompt: str) -> str:
    """Deterministic model-free fallback: a coarse color and brightness
    phrase, so that the datagen pipeline runs without MLLM weights."""
    arr = np.asarray(image, np.float32)
    if arr.max() > 2.0:
        arr = arr / 255.0
    mean = arr.reshape(-1, arr.shape[-1]).mean(axis=0)
    channel = ["red", "green", "blue"][int(np.argmax(mean[:3]))]
    tone = "bright" if mean.mean() > 0.5 else "dark"
    return f"a {tone} {channel} toned item"
