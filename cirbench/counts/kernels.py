"""Bytes and operations of the port's kernels at their shapes, and the
least time each could take (PERF.md, Findings: inputs read once, outputs
written once; a float32 product on the tensor cores as three TF32
products)."""

from __future__ import annotations

from cirbench.counts.model import attention_pairs
from cirbench.counts.peaks import bound_s

ITEM = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}


def attention_fwd_s(bh: int, s: int, d: int, causal: bool, dtype: str) -> float:
    """#1 / #3: q, k, v read and o written; two products per pair."""
    n_bytes = 4 * bh * s * d * ITEM[dtype]
    flops = 2 * 2 * attention_pairs(s, causal) * d * bh
    return bound_s(n_bytes, flops, dtype)


def attention_bwd_s(bh: int, s: int, d: int, causal: bool, dtype: str) -> float:
    """#2 / #4: q, k, v, o and dO read, dq, dk, dv written (7 tensors);
    five products per pair."""
    n_bytes = 7 * bh * s * d * ITEM[dtype]
    flops = 5 * 2 * attention_pairs(s, causal) * d * bh
    return bound_s(n_bytes, flops, dtype)


def bank_infonce_s(b: int, m: int, d: int, bank_dtype: str) -> float:
    """#5 + #6 of one step: the logits (3 TF32 products over a float32
    bank, 2 over bfloat16 / int8), then the coefficients and dq (twice
    the products), against the bank read once per kernel and the
    (B, splits) coefficient scratch neglected."""
    terms = 3 if bank_dtype == "float32" else 2
    bank_bytes = m * d * ITEM[bank_dtype]
    q_bytes = b * d * 4
    fwd = bound_s(bank_bytes + q_bytes, terms * 2 * b * m * d, "tf32")
    bwd = bound_s(bank_bytes + 2 * q_bytes, terms * 4 * b * m * d, "tf32")
    return fwd + bwd


def max_query_s(b: int, m: int, q: int, d: int, bank_dtype: str,
                routed_rows: int) -> float:
    """#9 + #10 of one step: #9 reads the bank and writes (B, M) float32
    residuals; #10 reads the residuals, the distinct routed rows
    (`routed_rows` of M * Q, each of D values) and writes dfeats."""
    fwd = bound_s(m * q * d * ITEM[bank_dtype] + b * m * 4 * 2,
                  3 * 2 * b * m * q * d, "tf32")
    bwd = bound_s(b * m * 4 * 2 + routed_rows * d * ITEM[bank_dtype],
                  2 * b * m * d, "float32")
    return fwd + bwd
