"""Qwen2-VL-2B [arXiv:2409.12191; hf] — VLM backbone with M-RoPE.

Backbone only, per the brief: the vision tower is a STUB — input_specs()
provides precomputed patch embeddings plus (t, h, w) position-id streams for
the sectioned multimodal rotary (M-RoPE).
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, TrainConfig, UMConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="qwen2-vl-2b",
        family="vlm",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        d_ff=8960,
        vocab_size=151_936,
        activation="swiglu",
        norm="rmsnorm",
        qkv_bias=True,
        rope="mrope",
        rope_theta=1_000_000.0,
        frontend="vision",
        tie_embeddings=True,
    ),
    train=TrainConfig(remat="full"),
    um=UMConfig(advises={"embedding": ("read_mostly",)}),
)
