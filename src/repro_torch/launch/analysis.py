"""Roofline analysis of a traced step: the counterpart of
``repro.launch.analysis``, with an H100's constants and with the counts
taken from the traced operations instead of XLA's compiled HLO.

Terms (per chip, per step):

  compute    = FLOPs / (chips x 989 TFLOP/s bf16)
  memory     = bytes / (chips x 3.35 TB/s HBM)
  collective = collective_bytes / (chips x 50 GB/s per link)

Constants (NVIDIA H100 SXM5 80 GB at its 700 W power limit):

  * PEAK_FLOPS 989e12: dense bf16 tensor-core FLOP/s, NVIDIA's H100 data
    sheet (without sparsity).
  * HBM_BW 3.35e12: HBM3 bytes/s, the same data sheet.
  * LINK_BW 50e9: the per-GPU rate of the slowest link that an axis of 16
    crosses.  A node holds 8 H100s, so an axis of 16 spans two nodes and
    its ring runs over the inter-node network: one 400 Gb/s NDR InfiniBand
    adapter per GPU (DGX H100), 50e9 bytes/s each way.
  * NVLINK_BW 450e9: NVLink 4 inside a node, 900 GB/s per GPU both ways
    together (the data sheet), 450e9 each way; recorded beside it, for an
    axis that stays inside a node.

``TraceCounter`` counts, at the level of each rank's local tensors, the
FLOPs of every operation (``torch.utils.flop_counter``'s formulas), the
bytes it reads and writes (its tensor inputs and outputs; views move
none), the live bytes of tensor storage (the peak is the step's memory),
and every collective with its output bytes.  ``CollectiveStats`` keeps
the reference's keys and ``link_bytes`` formula (ring approximations):
all-gather: out_bytes | all-reduce: 2 x out_bytes | reduce-scatter,
all-to-all, collective-permute: out_bytes.  Each collective is also
filed under what asked for it (``TraceCounter.sites``): the DTensor
operation or redistribution, the port's call site and the operand.

A traced loop is counted in full (the port's layers are a Python loop,
not a scan), so the L=1 / L=2 probes of the dry-run extrapolate exactly
what a full trace counts; they keep the trace of a deep model short.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import weakref

import torch
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# --- hardware constants (H100 SXM5 80 GB, 700 W; see the module docstring) --
PEAK_FLOPS = 989e12          # bf16 dense, per GPU
HBM_BW = 3.35e12             # bytes/s per GPU
LINK_BW = 50e9               # bytes/s per GPU, inter-node NDR (an axis of 16)
NVLINK_BW = 450e9            # bytes/s per GPU each way, inside a node of 8

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "send_": "collective-permute",
}
_FREE = {"detach", "wait_tensor", "device", "_to_copy_meta"}


@dataclasses.dataclass
class CollectiveStats:
    counts: dict[str, int]
    out_bytes: dict[str, int]

    @property
    def link_bytes(self) -> float:
        """Per-chip link-byte estimate (ring approximations)."""
        b = self.out_bytes
        return (
            b.get("all-gather", 0)
            + 2 * b.get("all-reduce", 0)
            + b.get("reduce-scatter", 0)
            + b.get("all-to-all", 0)
            + b.get("collective-permute", 0)
        )

    def as_dict(self) -> dict:
        return {"counts": dict(self.counts), "out_bytes": dict(self.out_bytes),
                "link_bytes": self.link_bytes}


def _storage_bytes(t: torch.Tensor) -> tuple[int, int]:
    st = t.untyped_storage()
    return id(st), st.nbytes()


class _Planning:
    """DTensor works out an operation's output shape by running it on fake
    tensors of the global shape, and a strided shard's offsets with small
    index tensors; those runs are DTensor's planning, not the step's work,
    and happen once per cached case.  While ``dtensor_planning`` is active
    the two private methods that do this are wrapped: ``depth`` counts the
    planning runs under way (``TraceCounter`` counts nothing inside them),
    and while ``host`` is set a strided shard's offsets are computed on real
    host tensors (under fake tensors there is nothing to read back)."""

    depth = 0
    host = 0
    installed = 0
    saved: list = []


def planning_targets() -> list:
    """The (class, method name) pairs that ``dtensor_planning`` wraps.  A
    torch that lacks one raises: the counts would then take DTensor's
    planning runs for the step's work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard

    targets = [(ShardingPropagator, "_propagate_tensor_meta_non_cached"),
               (_StridedShard, "local_shard_size_and_offset")]
    for cls, name in targets:
        if name not in cls.__dict__:
            raise RuntimeError(
                f"torch {torch.__version__}: {cls.__name__}.{name} is gone; the trace "
                f"cannot tell DTensor's planning runs from the step's work")
    return targets


def _wrap(raw, host_math: bool):
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    fn = raw.__func__ if isinstance(raw, (staticmethod, classmethod)) else raw

    def wrapped(*args, **kwargs):
        _Planning.depth += 1
        try:
            if host_math and _Planning.host:
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        finally:
            _Planning.depth -= 1

    return type(raw)(wrapped) if isinstance(raw, (staticmethod, classmethod)) else wrapped


@contextlib.contextmanager
def dtensor_planning(*, host_index_math: bool = False):
    """Wrap DTensor's planning runs (see ``_Planning``); re-entrant.  With
    ``host_index_math`` a strided shard's offsets run on real host tensors
    (the dry-run's fake tensors)."""
    if not _Planning.installed:
        for cls, name in planning_targets():
            raw = cls.__dict__[name]
            _Planning.saved.append((cls, name, raw))
            setattr(cls, name, _wrap(raw, host_math=cls.__name__ == "_StridedShard"))
    _Planning.installed += 1
    _Planning.host += host_index_math
    try:
        yield
    finally:
        _Planning.host -= host_index_math
        _Planning.installed -= 1
        if not _Planning.installed:
            while _Planning.saved:
                cls, name, raw = _Planning.saved.pop()
                setattr(cls, name, raw)


def _port_frame(f) -> str | None:
    """``dir/file.py:line function`` for a frame of the port's own code
    (not this module), else None."""
    path = f.f_code.co_filename.replace("\\", "/")
    if "/repro_torch/" not in path or path.endswith("/launch/analysis.py"):
        return None
    return f"{path.rsplit('/repro_torch/', 1)[1]}:{f.f_lineno} {f.f_code.co_name}"


def _cause(last_op: str) -> tuple[str, str]:
    """(operation, site) behind a collective, from the Python stack: an
    explicit redistribution (its forward or backward), else the DTensor
    operation last dispatched (``last_op``), and the port's two innermost
    frames (in the backward pass the autograd call, with the operation
    naming the product or lookup being differentiated)."""
    op, sites = None, []
    f = sys._getframe(2)
    while f is not None and len(sites) < 2:
        path, name = f.f_code.co_filename.replace("\\", "/"), f.f_code.co_name
        if op is None and "/torch/distributed/tensor/" in path:
            if name == "redistribute_local_args":
                op = last_op
            elif path.endswith("/_redistribute.py") and name in ("forward", "backward"):
                op = "redistribute" if name == "forward" else "redistribute backward"
            elif path.endswith("/_api.py") and name in ("redistribute", "full_tensor"):
                op = name
        site = _port_frame(f)
        if site is not None:
            sites.append(site)
        f = f.f_back
    return op or last_op, " < ".join(sites) or "-"


class TraceCounter(TorchDispatchMode):
    """Counts what one rank's local operations do: FLOPs, bytes read and
    written, live tensor bytes (current and peak) and collectives.

    ``track(tree)`` adds tensors that exist before the trace (parameters,
    state, inputs) to the live bytes; the peak is then the step's peak
    memory on one device, as the caching allocator would see it without
    its rounding, workspaces and fragmentation."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.counts: dict[str, int] = {}
        self.out_bytes: dict[str, int] = {}
        self._seen: dict[int, int] = {}
        self._sites: dict[tuple, list] = {}
        self._op = "-"  # the DTensor operation last dispatched
        self._planning = None

    # -- live bytes ------------------------------------------------------------
    def _add(self, t: torch.Tensor) -> None:
        if isinstance(t, DTensor):
            t = t._local_tensor
        if t.device.type == "meta" and not hasattr(t, "fake_mode"):
            return
        key, n = _storage_bytes(t)
        if key in self._seen:
            return
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t.untyped_storage(), self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def track(self, tree) -> None:
        for t in pytree.tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._add(t)

    def reset_peak(self) -> None:
        self.peak = self.live

    def collectives(self) -> CollectiveStats:
        return CollectiveStats(dict(self.counts), dict(self.out_bytes))

    def sites(self) -> list[dict]:
        """Every collective's bytes filed by what caused it, the most link
        bytes (``CollectiveStats.link_bytes``' factors) first: each entry
        with its kind, the DTensor operation or redistribution that asked
        for it, the port's innermost frames, the local operand's dtype and
        shape, its count and its bytes."""
        rows = [{"kind": k, "op": op, "site": site, "operand": operand, "count": c,
                 "out_bytes": b, "link_bytes": b * (2 if k == "all-reduce" else 1)}
                for (k, op, site, operand), (c, b) in self._sites.items()]
        return sorted(rows, key=lambda r: -r["link_bytes"])

    # -- dispatch --------------------------------------------------------------
    def __enter__(self):
        self._planning = dtensor_planning()
        self._planning.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._planning.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            # an operation on DTensors: let DTensor run it, and count the
            # local operations and collectives it turns into
            self._op = str(func)
            return NotImplemented
        kwargs = kwargs or {}
        flat = pytree.tree_leaves((args, kwargs))
        out = func(*args, **kwargs)
        if _Planning.depth:
            return out
        name = func._schema.name.split("::")[-1]
        outs = [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            moved = outs or [t for t in flat if isinstance(t, torch.Tensor)]
            self.counts[kind] = self.counts.get(kind, 0) + 1
            nbytes = sum(t.numel() * t.element_size() for t in moved)
            self.out_bytes[kind] = self.out_bytes.get(kind, 0) + nbytes
            src = next((t for t in flat if isinstance(t, torch.Tensor)), None)
            operand = "-" if src is None else (
                f"{str(src.dtype).removeprefix('torch.')} {tuple(src.shape)}")
            site = self._sites.setdefault((kind, *_cause(self._op), operand), [0, 0])
            site[0] += 1
            site[1] += nbytes
        elif name not in _FREE and not func.is_view:
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            ins = [t for t in flat if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            self._add(t)
        return out


# ---------------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_chip: float     # probe-extrapolated, per chip
    hlo_bytes_per_chip: float
    collective_bytes_per_chip: float
    model_flops_total: float      # 6ND (dense) / 6·N_active·D (MoE) per step

    @property
    def compute_s(self) -> float:
        return self.hlo_flops_per_chip / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes_per_chip / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_chip / LINK_BW

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step estimate: max of the three overlappable terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total traced FLOPs — catches remat/dispatch waste."""
        total = self.hlo_flops_per_chip * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        t = self.step_time_s
        return self.model_flops_total / (self.chips * PEAK_FLOPS * t) if t else 0.0

    def as_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bound": self.bound,
            "step_time_s": self.step_time_s,
            "model_flops_total": self.model_flops_total,
            "hlo_flops_per_chip": self.hlo_flops_per_chip,
            "hlo_bytes_per_chip": self.hlo_bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_at_roofline": self.mfu,
        }


def model_flops(arch, shape) -> float:
    """MODEL_FLOPS per step: 6·N·D for training (N = active params),
    2·N·D for inference (forward only)."""
    m = arch.model
    n = m.active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    # decode: one token per sequence + attention over the KV cache
    flops = 2.0 * n * shape.global_batch
    if m.num_heads:
        eff = shape.seq_len if m.sliding_window is None else min(
            shape.seq_len, m.sliding_window)
        flops += (4.0 * m.num_heads * m.head_dim * eff
                  * m.num_layers * shape.global_batch)
    return flops


def extrapolate(stat1: float, stat2: float, num_layers: int) -> float:
    """L=1/L=2 probe -> full depth (per-layer-identical stacks)."""
    per_layer = stat2 - stat1
    base = stat1 - per_layer
    return base + num_layers * per_layer


def wkv_correction_flops(arch, shape) -> float:
    """The reference's analytic FLOPs of the RWKV6 WKV recurrence, which
    its cost analysis counts once per scan: ~6·H·N² per token per layer
    forward, x3 for fwd+bwd in training.  The port's trace counts the
    loop's element-wise work itself, so the dry-run does not add this."""
    m = arch.model
    if m.family != "ssm":
        return 0.0
    n = m.ssm_state or 64
    h = m.d_model // n
    per_token_layer = 6.0 * h * n * n
    mult = 3.0 if shape.kind == "train" else 1.0
    tokens = shape.tokens if shape.kind != "decode" else shape.global_batch
    return per_token_layer * tokens * m.num_layers * mult
