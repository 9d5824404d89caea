"""Qwen2 (arXiv:2407.10671): the pre-norm GQA decoder with RMSNorm, q, k
and v biases and a SwiGLU MLP."""
from __future__ import annotations

from perfbench.forms._decoder import (  # noqa: F401
    block_shapes,
    decode_layer_bytes,
    head,
    layer,
    layer_matrix_params,
    mixer_flops,
    port_fields,
    top_shapes,
)
from perfbench.forms._decoder import read as _read


def read(file: dict) -> dict:
    return _read(file, norm="rmsnorm", gated=True, eps_key="rms_norm_eps",
                 acts={"silu": "silu"})
