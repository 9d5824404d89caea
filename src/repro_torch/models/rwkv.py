"""RWKV6 "Finch" (arXiv:2404.05892): attention-free, data-dependent decay.

The counterpart of ``repro.models.rwkv``:

  time-mix:  token-shift lerp for r/k/v/g/w streams; the decay is
             data-dependent through a low-rank path:
             w_t = exp(-exp(w0 + tanh(xw @ A) @ B))            (per channel)
  WKV6:      per-head (N = head size) state S in R^{NxN}:
             y_t  = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
             S_t  = diag(w_t) S_{t-1} + k_t v_t^T
  channel-mix: token-shift + squared-ReLU MLP with a receptance gate.

Parameters keep the reference's names, nesting and dtypes: ``w0``,
``decay_A``, ``decay_B`` and ``u`` are fp32, the rest the model's dtype.
r, k, v and w go to fp32 for the recurrence, which runs as a loop over
time (the reference's is a ``lax.scan``, checkpointed in chunks of
``WKV_CHUNK``); y is cast back before the ``ln_x`` layernorm.  Decode is
the same recurrence one step at a time, from the carried shifts and state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import (
    Norm,
    _const,
    _weight,
    layernorm,
    merge_dims,
    split_ready,
    squared_relu,
)

DECAY_LORA = 64
WKV_CHUNK = 64  # the reference's checkpoint granularity: the port's loop has none


def head_size(cfg) -> int:
    return cfg.ssm_state or 64


def num_wkv_heads(cfg) -> int:
    return cfg.d_model // head_size(cfg)


class TimeMix(nn.Module):
    def __init__(self, cfg, dtype, device, generator=None):
        super().__init__()
        d, n, h = cfg.d_model, head_size(cfg), num_wkv_heads(cfg)
        std = d ** -0.5
        for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
            setattr(self, name, _const((d,), 0.5, dtype, device))
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, _weight((d, d), std, generator, dtype, device))
        self.w0 = _const((d,), -6.0, torch.float32, device)
        self.decay_A = _weight((d, DECAY_LORA), std, generator, torch.float32, device)
        self.decay_B = _weight((DECAY_LORA, d), DECAY_LORA ** -0.5, generator,
                               torch.float32, device)
        self.u = _weight((h, n), 0.1, generator, torch.float32, device)  # bonus
        self.ln_x = Norm(d, "layernorm", dtype, device)  # per-head group norm


class ChannelMix(nn.Module):
    def __init__(self, cfg, dtype, device, generator=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.mu_k = _const((d,), 0.5, dtype, device)
        self.mu_r = _const((d,), 0.5, dtype, device)
        self.w_k = _weight((d, f), d ** -0.5, generator, dtype, device)
        self.w_v = _weight((f, d), f ** -0.5, generator, dtype, device)
        self.w_r = _weight((d, d), d ** -0.5, generator, dtype, device)


class RWKVBlock(nn.Module):
    """One RWKV6 layer: ``ln1``, ``ln2`` (layernorm), ``tm`` and ``cm``."""

    def __init__(self, cfg, dtype, device, generator=None):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, "layernorm", dtype, device)
        self.ln2 = Norm(cfg.d_model, "layernorm", dtype, device)
        self.tm = TimeMix(cfg, dtype, device, generator)
        self.cm = ChannelMix(cfg, dtype, device, generator)


def _token_shift(x, shifted, mu):
    """lerp(x, shift(x), mu); ``shifted`` from the sequence or the state."""
    return x + (shifted - x) * mu


def _shift_seq(x, init=None):
    """shift(x)[t] = x[t-1]; position 0 gets ``init`` (zeros or the carried
    state)."""
    pad = torch.zeros_like(x[:, :1]) if init is None else init[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def wkv6_scan(r, k, v, w, u, state):
    """Run the WKV6 recurrence over time.

    r/k/v/w: (B,S,H,N); u: (H,N); state: (B,H,N,N) fp32.  Returns y
    (B,S,H,N) fp32 and the final state.  r^T diag(u) k v^T, the bonus
    term, is computed for all steps at once; each step then reads the
    state (y_t = r_t^T S_{t-1}) and updates it."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    bonus = (rf * u * kf).sum(dim=-1, keepdim=True) * vf      # (B,S,H,N)
    # time-major, shaped for the step's products: a step indexes each once
    rows, cols = (t.transpose(0, 1).unsqueeze(-2).contiguous() for t in (rf, vf))  # (S,B,H,1,N)
    keys, decays = (t.transpose(0, 1).unsqueeze(-1).contiguous() for t in (kf, wf))  # (S,B,H,N,1)
    ys = []
    for t in range(rf.shape[1]):
        ys.append(rows[t] @ state)                                          # (B,H,1,N)
        state = torch.addcmul(keys[t] * cols[t], decays[t], state)          # k v^T + w S
    return torch.cat(ys, dim=2).transpose(1, 2) + bonus, state


def data_dependent_decay(xw, tm):
    """w_t = exp(-exp(w0 + tanh(xw A) B)) in (0,1), fp32."""
    lora = torch.tanh(xw.float() @ tm.decay_A) @ tm.decay_B
    return torch.exp(-torch.exp(tm.w0 + lora))


def time_mix(tm, x, cfg, *, shift_state=None, wkv_state=None):
    """x: (B,S,d). Returns (y, (new_shift, new_wkv))."""
    B, S, d = x.shape
    n = head_size(cfg)
    h = d // n
    shifted = _shift_seq(x, shift_state)
    xr = _token_shift(x, shifted, tm.mu_r)
    xk = _token_shift(x, shifted, tm.mu_k)
    xv = _token_shift(x, shifted, tm.mu_v)
    xg = _token_shift(x, shifted, tm.mu_g)
    xw = _token_shift(x, shifted, tm.mu_w)

    r = split_ready(xr @ tm.w_r, -1, h).reshape(B, S, h, n)
    k = split_ready(xk @ tm.w_k, -1, h).reshape(B, S, h, n)
    v = split_ready(xv @ tm.w_v, -1, h).reshape(B, S, h, n)
    g = F.silu(xg @ tm.w_g)
    w = split_ready(data_dependent_decay(xw, tm), -1, h).reshape(B, S, h, n)

    if wkv_state is None:
        wkv_state = torch.zeros((B, h, n, n), dtype=torch.float32, device=x.device)
    y, wkv_state = wkv6_scan(r, k, v, w, tm.u, wkv_state)
    y = merge_dims(y, (B, S, d), -1, h).to(x.dtype)
    y = layernorm(y, tm.ln_x.scale, tm.ln_x.bias)  # ~group norm
    y = (y * g) @ tm.w_o
    return y, (x[:, -1], wkv_state)


def channel_mix(cm, x, *, shift_state=None):
    shifted = _shift_seq(x, shift_state)
    xk = _token_shift(x, shifted, cm.mu_k)
    xr = _token_shift(x, shifted, cm.mu_r)
    k = squared_relu(xk @ cm.w_k)
    r = torch.sigmoid(xr @ cm.w_r)
    return r * (k @ cm.w_v), x[:, -1]


def rwkv_block(p, x, cfg, state=None):
    """One RWKV6 layer. state = (tm_shift (B,d), cm_shift (B,d),
    wkv (B,H,N,N)) or None for training (zero init)."""
    tm_shift = cm_shift = wkv = None
    if state is not None:
        tm_shift, cm_shift, wkv = state
    h = layernorm(x, p.ln1.scale, p.ln1.bias)
    y, (tm_shift, wkv) = time_mix(p.tm, h, cfg, shift_state=tm_shift, wkv_state=wkv)
    x = x + y
    h = layernorm(x, p.ln2.scale, p.ln2.bias)
    y, cm_shift = channel_mix(p.cm, h, shift_state=cm_shift)
    x = x + y
    return x, (tm_shift, cm_shift, wkv)


def init_rwkv_state(cfg, batch: int, dtype, device):
    d, n, h = cfg.d_model, head_size(cfg), num_wkv_heads(cfg)
    return (torch.zeros((batch, d), dtype=dtype, device=device),
            torch.zeros((batch, d), dtype=dtype, device=device),
            torch.zeros((batch, h, n, n), dtype=torch.float32, device=device))
