"""Qwen2-7B [arXiv:2407.10671; hf] — dense GQA, QKV bias."""
from repro_torch.configs.base import ArchConfig, ModelConfig, TrainConfig, UMConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="qwen2-7b",
        family="dense",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18944,
        vocab_size=152_064,
        activation="swiglu",
        norm="rmsnorm",
        qkv_bias=True,
        rope="rope",
        rope_theta=1_000_000.0,
        tie_embeddings=False,
    ),
    train=TrainConfig(remat="full"),
    um=UMConfig(advises={"embedding": ("read_mostly",)}),
)
