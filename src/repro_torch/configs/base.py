"""Model and shape configs: the port's own copy of the parts of
``repro.configs.base`` that its attention paths need (the attention
geometry of a model, and the benchmark shapes).  Training, UM-policy and
mesh configs come with the slices that use them."""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "ssm", "hybrid", "moe", "audio", "vlm"]
Activation = Literal["swiglu", "gelu", "squared_relu", "geglu"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int            # query heads (0 for attention-free)
    num_kv_heads: int         # GQA kv heads
    d_ff: int
    vocab_size: int
    head_dim: int = 0
    activation: Activation = "swiglu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    qkv_bias: bool = False
    rope: Literal["rope", "mrope", "none"] = "rope"
    rope_theta: float = 10_000.0
    # MoE
    num_experts: int = 0      # 0 => dense FFN
    top_k: int = 0
    # attention extent
    sliding_window: int | None = None
    # SSM (hymba / rwkv)
    ssm_state: int = 0
    # audio (musicgen): parallel codebooks, summed embeddings + parallel heads
    num_codebooks: int = 1
    # modality frontend: inputs arrive as embeddings
    frontend: Literal["none", "audio", "vision"] = "none"
    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 for even sharding."""
        return -(-self.vocab_size // 256) * 256

    def reduce(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests."""
        scale_heads = max(1, self.num_heads // 8) if self.num_heads else 0
        scale_kv = max(1, self.num_kv_heads // 8) if self.num_kv_heads else 0
        # keep the GQA ratio sane
        if scale_heads and scale_kv:
            ratio = max(1, self.num_heads // self.num_kv_heads)
            scale_heads = scale_kv * min(ratio, 4)
        head_dim = 16
        d_model = max(32, scale_heads * head_dim) if scale_heads else 64
        return dataclasses.replace(
            self,
            num_layers=2,
            d_model=d_model,
            num_heads=scale_heads,
            num_kv_heads=scale_kv,
            head_dim=head_dim if scale_heads else 0,
            d_ff=2 * d_model + (d_model // 2 if self.d_ff % self.d_model else 0),
            vocab_size=128,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch
