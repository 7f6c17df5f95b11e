from spn4cir_tpu_torch.tokenizer.bpe import (
    CONTEXT_LENGTH,
    ClipTokenizer,
    fits_context,
    get_tokenizer,
    tokenize,
)

__all__ = [
    "CONTEXT_LENGTH",
    "ClipTokenizer",
    "fits_context",
    "get_tokenizer",
    "tokenize",
]
