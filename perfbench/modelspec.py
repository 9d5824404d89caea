"""A configuration file read as the model it describes.

``configs/<name>.json`` holds the published ``config.json`` keys (as run,
with every changed key under ``reduced``), ``model_type`` and the port's
config name under ``arch``.  ``ModelSpec`` is what the reference, the
weights and the bounds need of it; each ``model_type`` fixes the block's
form as the published architecture has it.
"""
from __future__ import annotations

import dataclasses

# The block's form for each published architecture: the norm, whether the
# MLP is gated, and the key of its norm epsilon.
FORMS = {
    "qwen2": {"norm": "rmsnorm", "gated": True, "eps_key": "rms_norm_eps"},
    "starcoder2": {"norm": "layernorm", "gated": False, "eps_key": "norm_epsilon"},
}
ACTIVATIONS = {"silu": "silu", "gelu_pytorch_tanh": "gelu_tanh"}


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    arch: str               # the port's config of the same model
    model_type: str
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float
    norm: str               # "rmsnorm" | "layernorm"
    norm_eps: float
    gated: bool
    act: str                # "silu" | "gelu_tanh"
    qkv_bias: bool
    tie: bool
    dtype: str              # "bfloat16" | "float32"
    window: int | None

    @property
    def padded_vocab(self) -> int:
        """The vocabulary rounded up to 256 rows, as the port lays out its
        table (the extra rows are never a token)."""
        return -(-self.vocab // 256) * 256


def spec_of(name: str, file: dict) -> ModelSpec:
    form = FORMS[file["model_type"]]
    heads = file["num_attention_heads"]
    window = file.get("sliding_window") if file.get("use_sliding_window", True) else None
    return ModelSpec(
        name=name, arch=file["arch"], model_type=file["model_type"],
        layers=file["num_hidden_layers"], d=file["hidden_size"], heads=heads,
        kv_heads=file["num_key_value_heads"],
        head_dim=file.get("head_dim") or file["hidden_size"] // heads,
        d_ff=file["intermediate_size"], vocab=file["vocab_size"],
        rope_theta=float(file["rope_theta"]), norm=form["norm"],
        norm_eps=float(file[form["eps_key"]]), gated=form["gated"],
        act=ACTIVATIONS[file["hidden_act"]],
        qkv_bias=bool(file.get("qkv_bias", file.get("use_bias", False))),
        tie=bool(file["tie_word_embeddings"]), dtype=file["torch_dtype"], window=window)


def block_shapes(m: ModelSpec) -> dict[str, tuple[tuple[int, ...], str, float]]:
    """One layer's tensors: name -> (shape, kind, scale), with the names
    the port's blocks use.  ``kind``: "normal" (N(0, scale^2)), "scale"
    (1 + N(0, scale^2), a norm's gain) or "bias" (N(0, scale^2))."""
    d, f = m.d, m.d_ff
    q, kv = m.heads * m.head_dim, m.kv_heads * m.head_dim
    out = {"ln1.scale": ((d,), "scale", 0.1)}
    if m.norm == "layernorm":
        out["ln1.bias"] = ((d,), "bias", 0.1)
    out.update({"attn.wq": ((d, q), "normal", d ** -0.5),
                "attn.wk": ((d, kv), "normal", d ** -0.5),
                "attn.wv": ((d, kv), "normal", d ** -0.5),
                "attn.wo": ((q, d), "normal", q ** -0.5)})
    if m.qkv_bias:
        out.update({"attn.bq": ((q,), "bias", 0.1), "attn.bk": ((kv,), "bias", 0.1),
                    "attn.bv": ((kv,), "bias", 0.1)})
    out["ln2.scale"] = ((d,), "scale", 0.1)
    if m.norm == "layernorm":
        out["ln2.bias"] = ((d,), "bias", 0.1)
    if m.gated:
        out["mlp.w_gate"] = ((d, f), "normal", d ** -0.5)
    out.update({"mlp.w_up": ((d, f), "normal", d ** -0.5),
                "mlp.w_down": ((f, d), "normal", f ** -0.5)})
    return out


def top_shapes(m: ModelSpec) -> dict[str, tuple[tuple[int, ...], str, float]]:
    """The tensors outside the layers: the embedding table, the final norm
    and, untied, the head; the tables have ``vocab`` rows here."""
    out = {"embedding": ((m.vocab, m.d), "normal", 0.02),
           "final_norm.scale": ((m.d,), "scale", 0.1)}
    if m.norm == "layernorm":
        out["final_norm.bias"] = ((m.d,), "bias", 0.1)
    if not m.tie:
        out["lm_head"] = ((m.vocab, m.d), "normal", 0.02)
    return out


def matrix_params(m: ModelSpec) -> int:
    """The matrix parameters a token multiplies by: every layer's
    projections and MLP, and the head (the tied table counted as the head)."""
    per_layer = sum(_numel(s) for name, (s, kind, _) in block_shapes(m).items()
                    if kind == "normal")
    return m.layers * per_layer + m.vocab * m.d


def _numel(shape) -> int:
    n = 1
    for x in shape:
        n *= x
    return n
