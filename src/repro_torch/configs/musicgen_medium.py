"""MusicGen-medium [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens.

Backbone only, per the brief: the EnCodec frontend is a STUB — input_specs()
provides precomputed frame embeddings.  The 4 RVQ codebooks are modeled as
summed embeddings + 4 parallel LM heads (the delay-pattern interleaving is a
data-layout concern handled by the pipeline, not the backbone).
kv=24 == num_heads => plain MHA.
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, TrainConfig, UMConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="musicgen-medium",
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        activation="gelu",
        norm="layernorm",
        rope="none",            # musicgen uses sinusoidal embeddings (frontend)
        num_codebooks=4,
        frontend="audio",
        tie_embeddings=False,
    ),
    train=TrainConfig(remat="full"),
    um=UMConfig(advises={"embedding": ("read_mostly",)}),
)
