"""Mixtral-8x22B [arXiv:2401.04088; hf] — MoE 8 experts top-2, SWA.
SWA bounds the KV working set => long_500k runs sub-quadratically."""
from repro_torch.configs.base import ArchConfig, ModelConfig, TrainConfig, UMConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        num_layers=56,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=16384,
        vocab_size=32768,
        activation="swiglu",
        norm="rmsnorm",
        rope="rope",
        num_experts=8,
        top_k=2,
        sliding_window=4096,
        tie_embeddings=False,
    ),
    train=TrainConfig(remat="full", microbatches=8),
    um=UMConfig(
        advises={
            "embedding": ("read_mostly",),
            "opt_state": ("preferred_location:host", "accessed_by:device"),
        },
        optimizer_offload="auto",
    ),
)
