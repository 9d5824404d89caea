"""Qwen2-72B [arXiv:2407.10671; hf] — dense GQA 80L; FSDP + optimizer
sharding; optimizer host-offload decided by the residency planner."""
from repro_torch.configs.base import ArchConfig, ModelConfig, TrainConfig, UMConfig

CONFIG = ArchConfig(
    model=ModelConfig(
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
