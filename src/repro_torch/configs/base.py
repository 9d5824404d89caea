"""Config system: dataclasses for model / shape / mesh / training / UM policy.

The port's own copy of ``repro.configs.base``, field for field, so that a
config compares equal to the reference's.  Every architecture provides an
``ArchConfig`` via ``repro_torch.configs.get_config(name)``; shapes come
from ``shapes.py``.  All sizes below are *logical*: tensors are made from
them by the model code (full width on the card, ``reduce()`` on the CPU).
"""
from __future__ import annotations

import dataclasses
import math
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
    # modality frontend (stub per brief): inputs arrive as embeddings
    frontend: Literal["none", "audio", "vision"] = "none"
    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up for even TP sharding (Megatron-style
        make-vocab-divisible; hymba's 32001 -> 32256). Padded logit columns
        are masked to -inf in logits_fn."""
        return -(-self.vocab_size // 256) * 256

    # -- parameter accounting (drives the residency planner & MODEL_FLOPS) ----
    def attn_params_per_layer(self) -> int:
        if self.num_heads == 0:
            return 0
        hq, hkv, dh, d = self.num_heads, self.num_kv_heads, self.head_dim, self.d_model
        p = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
        if self.qkv_bias:
            p += (hq + 2 * hkv) * dh
        return p

    def ffn_params_per_layer(self) -> int:
        d, f = self.d_model, self.d_ff
        mats = 3 if self.activation in ("swiglu", "geglu") else 2
        per_expert = mats * d * f
        if self.num_experts:
            return self.num_experts * per_expert + d * self.num_experts  # + router
        return per_expert

    def ssm_params_per_layer(self) -> int:
        """rwkv6 (time-mix + channel-mix treated via attn/ffn slots) or the
        hymba Mamba head path — rough but shape-accurate accounting, refined
        per-arch in models/."""
        if self.family == "ssm":       # rwkv6: time-mix ~ 5 d^2, lora decays small
            return 5 * self.d_model * self.d_model
        if self.family == "hybrid" and self.ssm_state:
            d_inner = self.num_heads * self.head_dim
            return 2 * self.d_model * d_inner + d_inner * (2 * self.ssm_state + 2)
        return 0

    def norm_params_per_layer(self) -> int:
        return 2 * self.d_model

    def params_per_layer(self) -> int:
        if self.family == "ssm":
            # rwkv6: time-mix (attn-slot) + channel-mix (ffn-slot)
            return self.ssm_params_per_layer() + 2 * self.d_model * self.d_ff + self.norm_params_per_layer()
        p = self.attn_params_per_layer() + self.ffn_params_per_layer() + self.norm_params_per_layer()
        if self.family == "hybrid":
            p += self.ssm_params_per_layer()
        return p

    def embedding_params(self) -> int:
        emb = self.num_codebooks * self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else self.num_codebooks * self.vocab_size * self.d_model
        return emb + head

    def total_params(self) -> int:
        return self.num_layers * self.params_per_layer() + self.embedding_params()

    def active_params(self) -> int:
        """Activated params per token (MoE: top_k of num_experts)."""
        if not self.num_experts:
            return self.total_params()
        dense_ffn = self.ffn_params_per_layer()
        active_ffn = (dense_ffn - self.d_model * self.num_experts) * self.top_k // self.num_experts
        per_layer = (
            self.attn_params_per_layer()
            + active_ffn
            + self.norm_params_per_layer()
            + self.d_model * self.num_experts
        )
        return self.num_layers * per_layer + self.embedding_params()

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        if self.num_heads == 0:
            return 0  # rwkv: O(1) state
        window = self.sliding_window
        per_layer = 2 * self.num_kv_heads * self.head_dim * dtype_bytes
        return self.num_layers * per_layer if window is None else self.num_layers * per_layer

    def reduce(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
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


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False

    @property
    def shape(self) -> tuple[int, ...]:
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def num_devices(self) -> int:
        return int(math.prod(self.shape))

    @property
    def data_size(self) -> int:
        return self.shape[-2] * (self.shape[0] if self.multi_pod else 1)

    @property
    def model_size(self) -> int:
        return self.shape[-1]


@dataclasses.dataclass(frozen=True)
class UMConfig:
    """The paper's technique as a first-class feature (DESIGN.md §4)."""

    advises: dict[str, tuple[str, ...]] = dataclasses.field(default_factory=dict)
    prefetch: bool = True
    oversubscription: Literal["auto", "forbid", "force"] = "auto"
    optimizer_offload: Literal["auto", "on", "off"] = "auto"
    kv_host_tier: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    grad_clip: float = 1.0
    microbatches: int = 1              # gradient accumulation
    remat: Literal["none", "full", "offload"] = "full"
    int8_moments: bool = False          # quantized optimizer state
    grad_compression: bool = False      # int8 inter-pod all-reduce
    master_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    model: ModelConfig
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    um: UMConfig = dataclasses.field(default_factory=UMConfig)

    @property
    def name(self) -> str:
        return self.model.name

    def supports_shape(self, shape: ShapeConfig) -> tuple[bool, str]:
        """long_500k needs sub-quadratic attention (DESIGN.md §5)."""
        if shape.name == "long_500k":
            subq = (
                self.model.family in ("ssm", "hybrid")
                or self.model.sliding_window is not None
            )
            if not subq:
                return False, (
                    "long_500k skipped: pure full-attention architecture "
                    "(sub-quadratic requirement, see DESIGN.md §5)"
                )
        return True, ""
