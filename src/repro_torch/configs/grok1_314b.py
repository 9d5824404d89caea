"""Grok-1 314B [hf:xai-org/grok-1; unverified] — MoE 8 experts top-2.

The flagship oversubscription case (DESIGN.md §5): optimizer state cannot fit
HBM on 256 chips -> the residency planner host-offloads it (or int8 moments),
exactly the paper's oversubscription scenario at datacenter scale.
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, TrainConfig, UMConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="grok-1-314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=32768,
        vocab_size=131_072,
        activation="geglu",
        norm="rmsnorm",
        rope="rope",
        num_experts=8,
        top_k=2,
        tie_embeddings=True,
    ),
    # int8 moments NOT forced here: the ResidencyPlanner escalates to them
    # when it detects oversubscription (decision is recorded per cell).
    train=TrainConfig(remat="full", microbatches=8),
    um=UMConfig(
        advises={
            "embedding": ("read_mostly",),
            "opt_state": ("preferred_location:host", "accessed_by:device"),
        },
        optimizer_offload="auto",
        oversubscription="auto",
    ),
)
