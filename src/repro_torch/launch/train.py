"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --steps 50 [--batch 8 --seq 128] [--ckpt-dir DIR] [--device cpu]

The counterpart of ``repro.launch.train``: --reduced (the default, as
there) trains the arch's reduced config; ``train(..., reduced=False)`` is
the full config, which only the card holds.  Integrates the AdamW(+int8)
optimizer, the synthetic pipeline, checkpoint/restart via TrainRunner and
the straggler watchdog, on the card unless the caller asks for the CPU.
It trains through ``build_train_step``'s ``GraphTrainStep``: on a card
each step after the first is one replay of a CUDA graph that updates the
params and the optimizer state in place, and a restart restores the
checkpoint into those same tensors.
Random weights come from a seeded ``torch.Generator`` (they cannot match
``jax.random``'s; ``params=`` takes weights carried across from JAX).
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataConfig, synthetic_batches
from repro_torch.device import resolve, same_device
from repro_torch.launch.step import _adamw_cfg, build_train_step
from repro_torch.models import init_params
from repro_torch.optim import init_state
from repro_torch.runtime import TrainRunner


def train(arch_name: str, *, steps: int = 50, reduced: bool = True,
          batch: int = 8, seq: int = 128, ckpt_dir: str | None = None,
          checkpoint_every: int = 20, fault_schedule=(), log_every: int = 10,
          seed: int = 0, device=None, params=None):
    """Train ``steps`` steps over ``min(steps, 16)`` synthetic batches,
    cycled; returns ((params, opt_state), RunReport).

    ``params``: a ``Transformer`` on the device (default: seeded random
    weights), which may have fewer blocks than the config has layers.
    ``ckpt_dir``: where checkpoints go, and where the run resumes from if
    it holds one (default: ``repro_torch_ckpt_<arch>`` in the temporary
    directory).  ``log_every`` is the reference's and, as there, unused.
    Each step ends by reading its metrics on the host, so the report's
    step times are the device's.
    """
    arch = get_config(arch_name)
    if reduced:
        arch = dataclasses.replace(
            arch, model=arch.model.reduce(),
            train=dataclasses.replace(arch.train, microbatches=1,
                                      learning_rate=3e-3,
                                      warmup_steps=max(2, steps // 10)),
        )
    shape = ShapeConfig("cli", seq_len=seq, global_batch=batch, kind="train")
    dev = resolve(device)
    if params is None:
        params = init_params(arch.model, torch.Generator(device=dev).manual_seed(seed), dev)
    elif not same_device(next(params.parameters()).device, dev):
        raise ValueError(f"train: params are on {next(params.parameters()).device}, "
                         f"the run on {dev}")
    else:  # weights cut in depth train at their depth
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, num_layers=len(params.blocks)))

    opt = init_state(params, _adamw_cfg(arch, None))
    step_inner = build_train_step(arch, shape, None, None, total_steps=steps, device=dev)

    def step_fn(state, batch_np, step):
        params, opt = state
        batch_dev = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        params, opt, metrics = step_inner(params, opt, batch_dev, step)
        return (params, opt), {k: float(v) for k, v in metrics.items()}

    ckpt = Checkpointer(ckpt_dir or Path(tempfile.gettempdir()) / f"repro_torch_ckpt_{arch_name}",
                        keep_last=2)
    runner = TrainRunner(step_fn, ckpt, checkpoint_every=checkpoint_every,
                         fault_schedule=fault_schedule)
    batches = []
    gen = synthetic_batches(arch.model, shape, DataConfig(seed=seed))
    for _ in range(min(steps, 16)):
        batches.append(next(gen))

    t0 = time.time()
    state, report = runner.run((params, opt), batches, steps)
    dt = time.time() - t0
    if report.losses:
        print(f"[{arch_name}] steps={report.steps_completed} "
              f"restarts={report.restarts} "
              f"loss {report.losses[0]:.4f} -> {report.losses[-1]:.4f} "
              f"({dt:.1f}s, {dt / max(report.steps_completed, 1) * 1e3:.0f} ms/step) on {dev}")
    return state, report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="starcoder2-3b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    train(args.arch, steps=args.steps, reduced=args.reduced,
          batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir, device=args.device)


if __name__ == "__main__":
    main()
