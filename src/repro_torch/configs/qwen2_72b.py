"""Qwen2-72B [arXiv:2407.10671; hf] — dense GQA, 80 layers."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152_064,
    activation="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope="rope",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)
