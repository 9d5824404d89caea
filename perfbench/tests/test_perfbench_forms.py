"""The forms of ``perfbench/forms/`` against the values the harness gave
before the block's arithmetic moved there: the seed's weights, the
reference's served logits and ``loss_sum`` gradients, and the FLOP and
byte bounds of qwen2-7b and starcoder2-3b at tiny sizes, bit for bit.

``golden_forms.json`` holds those values, as ``golden_values()`` computed
them on the commit before the forms existed (one CPU thread, fp32 and bf16
weights): sha256 digests of the tensors' bytes and the bounds' numbers.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path

import pytest
import torch

from perfbench import bounds
from perfbench import weights as W
from perfbench.modelspec import spec_of
from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train
from perfbench.tests.helpers import tiny_file

GOLDEN = Path(__file__).with_name("golden_forms.json")
NAMES = ("qwen2-7b", "starcoder2-3b")
CPU = torch.device("cpu")
SEED = 2**31 + 77


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for name, t in tensors:
        h.update(name.encode())
        h.update(t.detach().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _weights(m) -> str:
    named = []
    for i in range(m.layers):
        named += [(f"blocks.{i}.{k}", v) for k, v in W.block(m, i, SEED, CPU).items()]
    return _digest(named + list(W.top(m, SEED, CPU).items()))


def golden_values(name: str) -> dict:
    """The values the golden test compares, for the tiny copy of ``name``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        file = tiny_file(name)
        m = spec_of(name, file)
        bf16 = spec_of(name, {**file, "torch_dtype": "bfloat16"})
        ids = W.tokens(SEED, "prompt", 0, (3, 40), m.vocab, CPU)
        logits = ref_model.served_logits(m, SEED, ids, 30, block_rows=2)
        batch = W.train_batch(SEED, 0, 2, 24, m.vocab, CPU)
        params = {k: v.requires_grad_(True) for k, v in ref_train.initial(m, SEED, CPU).items()}
        loss = ref_train.loss_sum(params, batch["tokens"], batch["labels"], m)
        loss.backward()
        windowed = dataclasses.replace(m, window=16)
        return {
            "weights_fp32": _weights(m),
            "weights_bf16": _weights(bf16),
            "served_logits": _digest([("logits", logits)]),
            "loss_sum": float(loss.detach()),
            "gradients": _digest((k, p.grad) for k, p in params.items()),
            "prefill_flops": [bounds.prefill_flops(x, b, p) for x in (m, bf16, windowed)
                              for b, p in ((1, 40), (3, 17))],
            "decode_step_bytes": [bounds.decode_step_bytes(x, b, p, g) for x in (m, bf16, windowed)
                                  for b, p, g in ((1, 40, 8), (3, 17, 5))],
            "train_step_flops": [bounds.train_step_flops(x, b, s) for x in (m, bf16, windowed)
                                 for b, s in ((2, 24), (4, 33))],
        }
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name", NAMES)
def test_the_forms_give_the_values_of_the_block_before_them(name):
    want = json.loads(GOLDEN.read_text())[name]
    assert golden_values(name) == want
