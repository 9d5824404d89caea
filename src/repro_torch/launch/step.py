"""Step builders for serving: the counterparts of
``repro.launch.step.build_prefill_step`` and ``build_serve_step`` (greedy
argmax), for every family.  The train step, with the residency plan's
optimizer placement, comes with the port's optimizer slice."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf


def build_prefill_step(arch: ArchConfig):
    cfg = arch.model

    def prefill_step(params, batch):
        logits, caches = tf.prefill(params, batch, cfg)
        return logits.argmax(dim=-1), caches

    return prefill_step


def build_serve_step(arch: ArchConfig):
    """One-token decode step: greedy sample + cache update (in place)."""
    cfg = arch.model

    def serve_step(params, batch, caches, cache_len):
        logits, caches = tf.decode_step(params, batch, caches, cache_len, cfg)
        return logits.argmax(dim=-1), caches

    return serve_step
