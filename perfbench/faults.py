"""Faults planted in the program's timed path, each of which a cell's
comparison has to catch: ``frozen_state``, a train step that returns its
state unchanged; ``half_batch``, half of each batch left out and the loss
taken as the mean over the rest; ``altered_token``, one served token of
every decode step replaced, where the step that ``serve`` builds produces
it, by the one the step ranks last.  The cells run on one card, so no exchange between cards can
be left out."""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def planted(name: str):
    import repro_torch.launch.step as step_mod

    if name == "frozen_state":
        target, attr = step_mod, "apply_updates"
        fault = _frozen
    elif name == "half_batch":
        target, attr = step_mod.tf, "loss_fn"
        fault = _half(step_mod.tf.loss_fn)
    elif name == "altered_token":
        import repro_torch.launch.serve as serve_mod

        target, attr = serve_mod, "build_serve_step"
        fault = _altered(serve_mod.build_serve_step)
    else:
        raise ValueError(f"no fault {name!r}")
    real = getattr(target, attr)
    setattr(target, attr, fault)
    try:
        yield
    finally:
        setattr(target, attr, real)


def _frozen(params, grads, state, cfg, lr):
    return params, state


def _half(loss_fn):
    def half(params, batch, cfg, **kw):
        n = batch["tokens"].shape[0] // 2
        return loss_fn(params, {k: v[:n] for k, v in batch.items()}, cfg, **kw)
    return half


class _Altered:
    """A serve step whose every call serves, in its first row, the token
    the step ranks last."""

    def __init__(self, step):
        self._step = step

    def __call__(self, params, batch, caches, cache_len):
        nxt, caches = self._step(params, batch, caches, cache_len)
        nxt = nxt.clone()
        nxt[0] = self._step.logits[0].argmin()
        return nxt, caches

    def __getattr__(self, name):
        return getattr(self._step, name)


def _altered(build):
    def altered(arch, mesh=None, *, device=None):
        return _Altered(build(arch, mesh, device=device))
    return altered


NAMES = ("frozen_state", "half_batch", "altered_token")
