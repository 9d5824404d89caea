"""Batched serving example: prefill + decode across architecture families
(GQA dense, MoE+SWA ring cache, RWKV recurrent state, multi-codebook audio).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

The counterpart of ``examples/serve_lm.py``, on the card unless asked for
the CPU.
"""
from __future__ import annotations

import argparse

from repro_torch.launch import serve

ARCHS = ("qwen2-7b", "mixtral-8x22b", "rwkv6-3b", "musicgen-medium")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = [] if args.device is None else ["--device", args.device]
    for arch in ARCHS:
        serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "32", "--gen", "12",
                    *device])


if __name__ == "__main__":
    main()
