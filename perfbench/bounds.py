"""The least time the card could take: FLOPs and bytes from shapes at the
published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W).

Serving (prefill then decode): the prefill's FLOPs are 2 x the layers'
matrix parameters a token multiplies by x the prompt tokens, the head at the
last position, QK^T and PV over the causal band (the window where it is
shorter) and the form's other mixers; a decode step's bytes are what the
form's layers read at the batch, the final norm, the head, the tokens'
embedding rows and the live K/V rows (their mean over the steps).
Training: 6 x the matrix parameters x the tokens, and causal QK^T and PV
forward and backward (3 x 4 Hq Dh S(S+1)/2 L B, the window capping each
query's keys) and 3 x the other mixers; remat's recompute is not counted.
What depends on the block is the form's (``modelspec.load_form``).
"""
from __future__ import annotations

from perfbench.modelspec import ModelSpec, form_of, matrix_params, numel

PEAK_BF16_FLOPS = 989e12     # dense tensor cores
PEAK_BYTES_PER_S = 3.35e12   # HBM3
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def _pairs(prompt: int, window: int | None) -> int:
    """Causal (query, key) pairs of a prompt, each query's keys capped at
    the window."""
    w = window or prompt
    return sum(min(q + 1, w) for q in range(prompt))


def prefill_flops(m: ModelSpec, batch: int, prompt: int) -> float:
    form = form_of(m)
    layer_mats = m.layers * form.layer_matrix_params(m)
    return (2 * layer_mats * batch * prompt + 2 * m.d * m.vocab * batch
            + 4 * m.heads * m.head_dim * _pairs(prompt, m.window) * m.layers * batch
            + m.layers * form.mixer_flops(m) * batch * prompt)


def decode_step_bytes(m: ModelSpec, batch: int, prompt: int, gen: int) -> float:
    form, elt = form_of(m), DTYPE_BYTES[m.dtype]
    norm = sum(numel(s) for s, kind, _ in form.top_shapes(m).values() if kind != "normal")
    weights = (m.layers * form.decode_layer_bytes(m, batch)
               + (norm + m.vocab * m.d + batch * m.d) * elt)
    live = min(prompt + gen / 2, m.window or prompt + gen)
    kv = 2 * m.layers * batch * live * m.kv_heads * m.head_dim * elt
    return weights + kv


def paged_step_bytes(m: ModelSpec, batch: int, cache_len: int) -> float:
    """The bytes one decode step at ``cache_len`` must move through decode
    attention: every layer reads the live K and V rows (cache_len + 1, the
    window capping them) and q, and writes the output (B x Hq x Dh).  Live
    rows only: the pages a kernel reads past them, its partial results and
    the block table are not counted."""
    rows = min(cache_len + 1, m.window or cache_len + 1)
    kv = 2 * rows * m.kv_heads * m.head_dim
    q_out = 2 * m.heads * m.head_dim
    return m.layers * batch * (kv + q_out) * DTYPE_BYTES[m.dtype]


def paged_decode_bytes(m: ModelSpec, batch: int, prompt: int, gen: int) -> float:
    """The bytes a call's gen - 1 decode steps must move through decode
    attention, cache_len from ``prompt`` on (``paged_step_bytes``)."""
    return sum(paged_step_bytes(m, batch, n) for n in range(prompt, prompt + gen - 1))


def serve_call_bound_s(m: ModelSpec, batch: int, prompt: int, gen: int) -> float:
    """One serve call's least time: the prefill at the bf16 peak and its
    gen - 1 decode steps at the memory rate."""
    return (prefill_flops(m, batch, prompt) / PEAK_BF16_FLOPS
            + (gen - 1) * decode_step_bytes(m, batch, prompt, gen) / PEAK_BYTES_PER_S)


def train_step_flops(m: ModelSpec, batch: int, seq: int) -> float:
    return (6 * matrix_params(m) * batch * seq
            + 12 * m.heads * m.head_dim * _pairs(seq, m.window) * m.layers * batch
            + 3 * m.layers * form_of(m).mixer_flops(m) * batch * seq)
