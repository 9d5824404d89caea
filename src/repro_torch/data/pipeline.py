"""Synthetic sharded token pipeline with double-buffered device prefetch.

The counterpart of ``repro.data.pipeline``: a deterministic per-(step,
host) NumPy PRNG stream gives host batches, bit for bit the reference's,
and ``PrefetchIterator`` copies batch k+1 to the card while batch k
computes (the cudaMemPrefetchAsync analogue at the input pipeline level,
paper §II-C).  A real deployment swaps ``synthetic_batches`` for a
tokenized shard reader; everything downstream is unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.prefetch import PrefetchIterator


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    process_index: int = 0
    process_count: int = 1


def _batch_shape(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        return {"tokens": (B, S, cfg.num_codebooks), "labels": (B, S, cfg.num_codebooks)}
    if cfg.family == "vlm":
        return {"embeds": (B, S, cfg.d_model), "labels": (B, S),
                "positions_thw": (B, S, 3)}
    return {"tokens": (B, S), "labels": (B, S)}


def synthetic_batches(cfg: ModelConfig, shape: ShapeConfig,
                      data: DataConfig = DataConfig()) -> Iterator[dict]:
    """Infinite deterministic batch stream (host numpy).

    Labels are next-token shifts of the tokens so the loss is learnable
    (structure: a noisy copy task keeps optimization meaningful in tests).
    """
    shapes = _batch_shape(cfg, shape)
    step = 0
    while True:
        rng = np.random.default_rng(
            (data.seed * 1_000_003 + step) * 97 + data.process_index
        )
        out = {}
        if "tokens" in shapes:
            toks = rng.integers(0, cfg.vocab_size, shapes["tokens"], dtype=np.int32)
            # learnable structure (copy task): odd positions repeat the even
            # ones, so next-token loss can fall to ~0.5*ln(V)
            toks[:, 1::2] = toks[:, 0::2][:, : toks[:, 1::2].shape[1]]
            out["tokens"] = toks
            labels = np.roll(toks, -1, axis=1)
            out["labels"] = labels
        if "embeds" in shapes:
            out["embeds"] = rng.standard_normal(shapes["embeds"]).astype(np.float32)
            out["labels"] = rng.integers(0, cfg.vocab_size, shapes["labels"], dtype=np.int32)
            t = np.arange(shape.seq_len, dtype=np.int32)
            out["positions_thw"] = np.broadcast_to(
                np.stack([t, t, t], -1), shapes["positions_thw"]
            ).copy()
        yield out
        step += 1


def prefetched(cfg: ModelConfig, shape: ShapeConfig, device=None,
               data: DataConfig = DataConfig(), depth: int = 2) -> PrefetchIterator:
    """``synthetic_batches`` through a ``PrefetchIterator`` on ``device``
    (default: the card; raises without one)."""
    return PrefetchIterator(synthetic_batches(cfg, shape, data),
                            device=device, depth=depth)
