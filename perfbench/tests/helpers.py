"""Shared by the benchmark's tests: the repository's root and tiny copies
of the two configurations."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# Tiny copies of the two configurations: the published keys with small
# sizes and fp32, so that the port and the reference agree to rounding.
TINY = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "vocab_size": 256, "torch_dtype": "float32"}
TINY_FF = {"qwen2-7b": 160, "starcoder2-3b": 256}


def tiny_file(name: str) -> dict:
    from perfbench import spec

    file = spec.load_config(name)
    file.update(TINY, intermediate_size=TINY_FF[name])
    return file
