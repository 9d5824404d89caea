"""Hymba-1.5B [arXiv:2411.13676; hf] — hybrid: parallel attention + Mamba
heads in every layer, ssm_state=16, SWA on the attention path."""
from repro_torch.configs.base import ArchConfig, ModelConfig, TrainConfig, UMConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        d_ff=5504,
        vocab_size=32001,
        activation="swiglu",
        norm="rmsnorm",
        rope="rope",
        ssm_state=16,
        sliding_window=1024,    # Hymba uses SWA in all but 3 layers; we use SWA throughout
        tie_embeddings=True,
    ),
    train=TrainConfig(remat="full"),
    um=UMConfig(advises={"embedding": ("read_mostly",)}),
)
