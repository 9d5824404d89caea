"""Weights and inputs made from ``--seed``, the same for the program and
the reference.

Each layer's tensors come from one ``torch.randn`` call of a generator of
their own (seeded from the run's seed and the layer's index), on the
device and in the dtype that is served, so that the reference can make any
layer again, alone, bit for bit.  Token ids come likewise, one generator a
call or a step.
"""
from __future__ import annotations

import hashlib

import torch

from perfbench.modelspec import ModelSpec, form_of, numel

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def seed_of(seed: int, *tags) -> int:
    """A 63-bit generator seed for ``tags`` of the run's ``seed`` (any whole
    number, however large)."""
    text = "/".join(str(t) for t in (seed,) + tags).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(), "little") >> 1


def _make(shapes: dict, seed: int, tag, dtype, device) -> dict[str, torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(seed_of(seed, *tag))
    sizes = [numel(s) for s, _, _ in shapes.values()]
    flat = torch.randn(sum(sizes), generator=g, dtype=dtype, device=device)
    out = {}
    for (name, (shape, kind, scale)), v in zip(shapes.items(), flat.split(sizes)):
        v = v.view(shape).mul_(scale)
        out[name] = v.add_(1.0) if kind == "scale" else v
    return out


def block(m: ModelSpec, i: int, seed: int, device, dtype=None) -> dict[str, torch.Tensor]:
    """Layer ``i``'s tensors, named as in its form's ``block_shapes``."""
    return _make(form_of(m).block_shapes(m), seed, ("layer", i), dtype or DTYPES[m.dtype], device)


def top(m: ModelSpec, seed: int, device, dtype=None) -> dict[str, torch.Tensor]:
    """The embedding, the final norm and (untied) the head."""
    return _make(form_of(m).top_shapes(m), seed, ("top",), dtype or DTYPES[m.dtype], device)


def tokens(seed: int, tag: str, index: int, shape, vocab: int, device) -> torch.Tensor:
    """int32 token ids, uniform over the vocabulary, for call or step
    ``index`` of kind ``tag``."""
    g = torch.Generator(device=device).manual_seed(seed_of(seed, tag, index))
    return torch.randint(0, vocab, shape, generator=g, device=device, dtype=torch.int64).to(
        torch.int32)


def train_batch(seed: int, index: int, batch: int, seq: int, vocab: int, device) -> dict:
    """Step ``index``'s batch: ``seq + 1`` ids a row, the tokens and their
    next-token labels."""
    ids = tokens(seed, "batch", index, (batch, seq + 1), vocab, device)
    return {"tokens": ids[:, :-1].contiguous(), "labels": ids[:, 1:].contiguous()}

