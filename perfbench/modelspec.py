"""A configuration file read as the model it describes.

``configs/<name>.json`` holds the published ``config.json`` keys (as run,
with every changed key under ``reduced``), ``model_type`` and the port's
config name under ``arch``.  ``ModelSpec`` is what the reference, the
weights and the bounds need of it.  Everything that depends on the block
belongs to the form of its ``model_type``, ``forms/<model_type>.py``
(``form_of``): the keys it reads, its tensors, its reference layer, the
port's config fields and its share of the bounds.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
from pathlib import Path

FORMS_DIR = Path(__file__).resolve().parent / "forms"


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    arch: str               # the port's config of the same model
    model_type: str         # the form: forms/<model_type>.py
    layers: int
    d: int
    heads: int              # attention's query heads (0 without attention)
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float
    norm: str               # "rmsnorm" | "layernorm"
    norm_eps: float
    gated: bool
    act: str                # reference.model.activation's kind
    qkv_bias: bool
    tie: bool
    dtype: str              # "bfloat16" | "float32"
    window: int | None
    sizes: dict = dataclasses.field(default_factory=dict)  # the form's own (experts, state)

    @property
    def padded_vocab(self) -> int:
        """The vocabulary rounded up to 256 rows, as the port lays out its
        table (the extra rows are never a token)."""
        return -(-self.vocab // 256) * 256


@functools.cache
def load_form(model_type: str):
    """The module ``forms/<model_type>.py``.  It declares ``read(file)``
    (the ``ModelSpec`` fields it takes from the file), ``block_shapes(m)``
    and ``top_shapes(m)`` (name -> (shape, kind, scale), in the order the
    weights are drawn), ``layer(p, x, m, mm)`` and ``head(x, top, m, mm)``
    (the plain fp32 reference), ``port_fields(m)`` (the port's
    ``ModelConfig`` fields it sets), ``layer_matrix_params(m)`` (the matrix
    parameters a token multiplies by in one layer), ``decode_layer_bytes(m,
    batch)`` (the bytes of one layer's weights and recurrent state a decode
    step of ``batch`` rows reads) and ``mixer_flops(m)`` (the forward FLOPs
    a token spends in one layer outside its matrices and attention)."""
    if not model_type.isidentifier() or not (FORMS_DIR / f"{model_type}.py").is_file():
        raise FileNotFoundError(f"no form perfbench/forms/{model_type}.py")
    return importlib.import_module(f"perfbench.forms.{model_type}")


def form_of(m: ModelSpec):
    return load_form(m.model_type)


def spec_of(name: str, file: dict) -> ModelSpec:
    form = load_form(file["model_type"])
    return ModelSpec(name=name, arch=file["arch"], model_type=file["model_type"],
                     **form.read(file))


def matrix_params(m: ModelSpec) -> int:
    """The matrix parameters a token multiplies by: every layer's, and the
    head (the tied table counted as the head)."""
    return m.layers * form_of(m).layer_matrix_params(m) + m.vocab * m.d


def numel(shape) -> int:
    n = 1
    for x in shape:
        n *= x
    return n
