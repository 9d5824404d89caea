"""Nemotron-4-15B [arXiv:2402.16819; unverified] — dense GQA, squared-ReLU,
256k vocab (READ_MOSTLY leverage on the giant embedding)."""
from repro_torch.configs.base import ArchConfig, ModelConfig, TrainConfig, UMConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="nemotron-4-15b",
        family="dense",
        num_layers=32,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=24576,
        vocab_size=256_000,
        activation="squared_relu",
        norm="layernorm",
        rope="rope",
        tie_embeddings=False,
    ),
    train=TrainConfig(remat="full"),
    um=UMConfig(advises={"embedding": ("read_mostly",)}),
)
