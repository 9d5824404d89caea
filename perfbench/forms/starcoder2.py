"""StarCoder2 (arXiv:2402.19173): the pre-norm GQA decoder with LayerNorm
and a GELU-tanh MLP, biases as the file's ``use_bias`` says."""
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
    return _read(file, norm="layernorm", gated=False, eps_key="norm_epsilon",
                 acts={"gelu_pytorch_tanh": "gelu_tanh"})
