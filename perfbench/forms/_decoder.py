"""The pre-norm GQA decoder block that qwen2 and starcoder2 share, and
that other forms build on: the attention sublayer
(``reference.model.attention``), then the pre-norm MLP (gated or not) and
its residual.  Noted departures, shared with the port as run:
starcoder2's linear layers carry no biases (``use_bias`` is false in its
file).
"""
from __future__ import annotations

from perfbench.bounds import DTYPE_BYTES
from perfbench.modelspec import ModelSpec, numel
from perfbench.reference.model import activation, attention, head, norm  # noqa: F401
from perfbench.reference.precision import FP32

# the port's activation of an MLP: (gated, the reference's kind) -> name
PORT_ACTIVATIONS = {(True, "silu"): "swiglu", (False, "gelu_tanh"): "gelu"}


def read(file: dict, *, norm: str, gated: bool, eps_key: str, acts: dict) -> dict:
    """The ``ModelSpec`` fields of a decoder's ``config.json`` keys;
    ``acts`` maps the file's ``hidden_act`` to the reference's kind."""
    if file["hidden_act"] not in acts:
        raise ValueError(f"hidden_act {file['hidden_act']!r} is not one of {sorted(acts)}")
    heads = file["num_attention_heads"]
    window = file.get("sliding_window") if file.get("use_sliding_window", True) else None
    return dict(
        layers=file["num_hidden_layers"], d=file["hidden_size"], heads=heads,
        kv_heads=file["num_key_value_heads"],
        head_dim=file.get("head_dim") or file["hidden_size"] // heads,
        d_ff=file["intermediate_size"], vocab=file["vocab_size"],
        rope_theta=float(file["rope_theta"]), norm=norm, norm_eps=float(file[eps_key]),
        gated=gated, act=acts[file["hidden_act"]],
        qkv_bias=bool(file.get("qkv_bias", file.get("use_bias", False))),
        tie=bool(file["tie_word_embeddings"]), dtype=file["torch_dtype"], window=window)


def norm_shapes(m: ModelSpec, prefix: str) -> dict:
    out = {f"{prefix}.scale": ((m.d,), "scale", 0.1)}
    if m.norm == "layernorm":
        out[f"{prefix}.bias"] = ((m.d,), "bias", 0.1)
    return out


def attention_shapes(m: ModelSpec) -> dict:
    """The attention sublayer's tensors: ``ln1``, the projections, the
    q, k and v biases."""
    d, q, kv = m.d, m.heads * m.head_dim, m.kv_heads * m.head_dim
    out = norm_shapes(m, "ln1")
    out.update({"attn.wq": ((d, q), "normal", d ** -0.5),
                "attn.wk": ((d, kv), "normal", d ** -0.5),
                "attn.wv": ((d, kv), "normal", d ** -0.5),
                "attn.wo": ((q, d), "normal", q ** -0.5)})
    if m.qkv_bias:
        out.update({"attn.bq": ((q,), "bias", 0.1), "attn.bk": ((kv,), "bias", 0.1),
                    "attn.bv": ((kv,), "bias", 0.1)})
    return out


def block_shapes(m: ModelSpec) -> dict[str, tuple[tuple[int, ...], str, float]]:
    """One layer's tensors: name -> (shape, kind, scale), with the names
    the port's blocks use.  ``kind``: "normal" (N(0, scale^2)), "scale"
    (1 + N(0, scale^2), a norm's gain) or "bias" (N(0, scale^2))."""
    d, f = m.d, m.d_ff
    out = {**attention_shapes(m), **norm_shapes(m, "ln2")}
    if m.gated:
        out["mlp.w_gate"] = ((d, f), "normal", d ** -0.5)
    out.update({"mlp.w_up": ((d, f), "normal", d ** -0.5),
                "mlp.w_down": ((f, d), "normal", f ** -0.5)})
    return out


def top_shapes(m: ModelSpec) -> dict[str, tuple[tuple[int, ...], str, float]]:
    """The tensors outside the layers: the embedding table, the final norm
    and, untied, the head; the tables have ``vocab`` rows here."""
    out = {"embedding": ((m.vocab, m.d), "normal", 0.02), **norm_shapes(m, "final_norm")}
    if not m.tie:
        out["lm_head"] = ((m.vocab, m.d), "normal", 0.02)
    return out


def mlp(p: dict, x, m: ModelSpec, mm=FP32):
    """The MLP sublayer: the pre-norm ``ln2``, the MLP, the residual."""
    h = norm(x, p, "ln2", m)
    if m.gated:
        u = activation(mm(h, p["mlp.w_gate"]), m.act) * mm(h, p["mlp.w_up"])
    else:
        u = activation(mm(h, p["mlp.w_up"]), m.act)
    return x + mm(u, p["mlp.w_down"])


def layer(p: dict, x, m: ModelSpec, mm=FP32):
    """One decoder layer over x (R, S, d), positions 0..S-1."""
    return mlp(p, attention(p, x, m, mm), m, mm)


def port_fields(m: ModelSpec) -> dict:
    """The port's ``ModelConfig`` fields of a dense decoder."""
    return dict(family="dense", d_model=m.d, num_heads=m.heads, num_kv_heads=m.kv_heads,
                head_dim=m.head_dim, d_ff=m.d_ff, vocab_size=m.vocab,
                activation=PORT_ACTIVATIONS[(m.gated, m.act)], norm=m.norm,
                qkv_bias=m.qkv_bias, rope="rope", rope_theta=m.rope_theta,
                sliding_window=m.window, tie_embeddings=m.tie, dtype=m.dtype)


def layer_matrix_params(m: ModelSpec) -> int:
    """Every matrix of the layer: the projections and the MLP."""
    return sum(numel(s) for s, kind, _ in block_shapes(m).values() if kind == "normal")


def decode_layer_bytes(m: ModelSpec, batch: int) -> int:
    """Every tensor of the layer, whatever the batch."""
    return sum(numel(s) for s, _, _ in block_shapes(m).values()) * DTYPE_BYTES[m.dtype]


def mixer_flops(m: ModelSpec) -> int:
    """Attention is the only mixer, and the bounds count it themselves."""
    return 0
