"""RWKV6 (Finch) 3B [arXiv:2404.05892; hf] — attention-free, data-dependent
decay.  O(1) decode state => long_500k runs."""
from repro_torch.configs.base import ArchConfig, ModelConfig, TrainConfig, UMConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        num_layers=32,
        d_model=2560,
        num_heads=0,            # attention-free; WKV6 head_size=64 internally
        num_kv_heads=0,
        d_ff=8960,
        vocab_size=65536,
        activation="squared_relu",   # rwkv channel-mix uses relu^2
        norm="layernorm",
        rope="none",
        ssm_state=64,           # WKV6 head size
        tie_embeddings=False,
    ),
    train=TrainConfig(remat="full"),
    um=UMConfig(advises={"embedding": ("read_mostly",)}),
)
