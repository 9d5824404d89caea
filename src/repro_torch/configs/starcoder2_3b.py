"""StarCoder2-3B [arXiv:2402.19173; hf] — dense GQA + RoPE."""
from repro_torch.configs.base import ArchConfig, ModelConfig, TrainConfig, UMConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="starcoder2-3b",
        family="dense",
        num_layers=30,
        d_model=3072,
        num_heads=24,
        num_kv_heads=2,
        d_ff=12288,
        vocab_size=49152,
        activation="gelu",
        norm="layernorm",
        rope="rope",
        rope_theta=999_999.0,
        tie_embeddings=True,
    ),
    train=TrainConfig(remat="full"),
    um=UMConfig(advises={"embedding": ("read_mostly",)}),
)
