"""End-to-end driver: train a reduced LM with the full stack — AdamW,
remat, checkpoint/restart with an injected fault, straggler watchdog.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--arch qwen2-7b] \\
        [--steps 200] [--device cpu]

The counterpart of ``examples/train_lm.py``, on the card unless asked for
the CPU.
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.launch.train import train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as d:
        state, report = train(
            args.arch, steps=args.steps, batch=8, seq=128,
            ckpt_dir=d, checkpoint_every=50,
            fault_schedule=(args.steps // 2,),   # chaos drill mid-run
            device=args.device,
        )
    print(f"restarts survived: {report.restarts}")
    print(f"straggler alerts: {len(report.straggler_alerts)}")
    print(f"loss: {report.losses[0]:.4f} -> {report.losses[-1]:.4f}")
    if not report.losses[-1] < report.losses[0]:
        raise RuntimeError("training must make progress")


if __name__ == "__main__":
    main()
