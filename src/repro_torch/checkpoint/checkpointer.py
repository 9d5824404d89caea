"""Async checkpointing (the fault-tolerance substrate).

The counterpart of ``repro.checkpoint.checkpointer``.  Layout (one
directory per step, atomic rename commit):

  <dir>/step_00000123.tmp/ -> <dir>/step_00000123/
      meta.json                      step, leaf count, dtypes and shapes
      shard_<process>.npz            this process's leaves

- ``save`` snapshots the tree on the caller's thread (every tensor copied
  to host memory, so that the next step may update the originals in place)
  and writes it on a background thread; an error surfaces on ``wait()``.
- A failed or partial save never becomes visible (tmp dir until rename);
  ``keep_last`` bounds disk usage.
- ``np.savez`` cannot hold bf16, so a bf16 tensor is stored as its
  ``uint16`` bits and ``meta.json`` records each leaf's torch dtype.
- ``restore`` writes into the target tree's tensors, on their devices
  (the module's parameters, the optimizer state), and returns the tree.

A tree is a tensor, an ``nn.Module`` (its ``state_dict``), or a dict, list
or tuple of trees; dict keys are taken in sorted order.
"""
from __future__ import annotations

import json
import pathlib
import re
import shutil
import threading
import time

import numpy as np
import torch
from torch import nn


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of ``tree`` in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return list(tree.state_dict(keep_vars=True).values())
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    raise TypeError(f"checkpoint: cannot store a {type(tree).__name__}")


def snapshot(tree) -> list[torch.Tensor]:
    """Host copies of the tensors of ``tree`` (waits for the device)."""
    return [x.detach().to("cpu", copy=True) for x in tree_leaves(tree)]


@torch.no_grad()
def copy_into(tree, leaves) -> None:
    """Write ``leaves`` (as ``tree_leaves`` orders them) into the tensors of
    ``tree``; each must have the same shape and dtype."""
    targets = tree_leaves(tree)
    if len(targets) != len(leaves):
        raise ValueError(f"checkpoint: {len(leaves)} leaves for a tree of {len(targets)}")
    for i, (dst, src) in enumerate(zip(targets, leaves)):
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(f"checkpoint: leaf {i} is {tuple(src.shape)} {src.dtype}, "
                             f"the target {tuple(dst.shape)} {dst.dtype}")
        dst.copy_(src)


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        return x.view(torch.uint16).numpy()
    return x.numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if dtype == "torch.bfloat16" else t


def default_process_index() -> int:
    """The ``torch.distributed`` rank when a process group exists, else 0."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Checkpointer:
    def __init__(self, directory: str | pathlib.Path, *, keep_last: int = 3,
                 process_index: int | None = None):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.process = default_process_index() if process_index is None else process_index
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree, *, blocking: bool = False) -> None:
        """Snapshot now (on the caller's thread), write in the background."""
        self.wait()
        host_leaves = snapshot(tree)

        def _write():
            try:
                tmp = self.dir / f"step_{step:08d}.tmp"
                final = self.dir / f"step_{step:08d}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                np.savez(tmp / f"shard_{self.process}.npz",
                         **{f"leaf_{i}": _to_numpy(a) for i, a in enumerate(host_leaves)})
                (tmp / "meta.json").write_text(json.dumps({
                    "step": step,
                    "num_leaves": len(host_leaves),
                    "dtypes": [str(a.dtype) for a in host_leaves],
                    "shapes": [list(a.shape) for a in host_leaves],
                    "time": time.time(),
                }))
                if final.exists():
                    shutil.rmtree(final)
                tmp.rename(final)         # atomic commit
                self._gc()
            except BaseException as e:  # noqa: BLE001 — surfaced on wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore ---------------------------------------------------------------
    def latest_step(self) -> int | None:
        steps = []
        for p in self.dir.iterdir():
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "meta.json").exists():
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def restore(self, step: int, target_tree):
        """Load the leaves of ``step`` into ``target_tree``'s tensors, in
        place, and return the tree."""
        path = self.dir / f"step_{step:08d}"
        meta = json.loads((path / "meta.json").read_text())
        with np.load(path / f"shard_{self.process}.npz") as data:
            leaves = [_from_numpy(data[f"leaf_{i}"], dt)
                      for i, dt in enumerate(meta["dtypes"])]
        copy_into(target_tree, leaves)
        return target_tree

    def restore_latest(self, target_tree):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target_tree)

    # -- gc -----------------------------------------------------------------
    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1))
            for p in self.dir.iterdir()
            if (m := re.fullmatch(r"step_(\d+)", p.name))
        )
        for s in steps[: max(0, len(steps) - self.keep_last)]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
