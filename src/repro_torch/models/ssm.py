"""Selective SSM (Mamba S6): the SSM half of Hymba's parallel heads.

The counterpart of ``repro.models.ssm``:

  dt_t = softplus(x_t W_dt + b)                 (d_inner,)
  B_t, C_t = x_t W_B, x_t W_C                   (N,)
  h_t = exp(dt_t A) * h_{t-1} + (dt_t B_t) x_t  (d_inner, N), A = -exp(A_log)
  y_t = h_t . C_t + D * x_t

dt, B and C are computed in fp32 (the weights cast to fp32) and y is cast
back to the input dtype; the causal conv runs in the input dtype.  The
reference scans time in chunks of ``SSM_CHUNK`` with an associative scan
inside each; the port runs the same recurrence as a loop over time, one
fused multiply-add of the (B, d_inner, N) state a step, which gives the
same states up to rounding on either of the reference's branches.
Decode is the single-step recurrence with carried (conv_state, ssm_state).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import BATCH, _const, _weight, linear, shard_hint

CONV_K = 4
SSM_CHUNK = 256  # the reference's chunk: the port's loop has none


class Mamba(nn.Module):
    """The Mamba head path's parameters, with the reference's names,
    layouts and dtypes: ``dt_bias``, ``A_log`` and ``D`` are fp32, the rest
    is the model's dtype."""

    def __init__(self, d_model: int, d_inner: int, n_state: int, dtype, device,
                 generator: torch.Generator | None = None):
        super().__init__()
        std = d_model ** -0.5
        self.in_proj = _weight((d_model, 2 * d_inner), std, generator, dtype, device)
        self.conv_w = _weight((CONV_K, d_inner), 0.2, generator, dtype, device)
        self.conv_b = _const((d_inner,), 0.0, dtype, device)
        self.w_dt = _weight((d_inner, d_inner), d_inner ** -0.5 * 0.1, generator, dtype, device)
        self.dt_bias = _const((d_inner,), math.log(math.expm1(0.01)), torch.float32, device)
        self.w_B = _weight((d_inner, n_state), d_inner ** -0.5, generator, dtype, device)
        self.w_C = _weight((d_inner, n_state), d_inner ** -0.5, generator, dtype, device)
        a_log = torch.log(torch.arange(1, n_state + 1, dtype=torch.float32, device=device))
        self.A_log = nn.Parameter(a_log[None, :].repeat(d_inner, 1))
        self.D = _const((d_inner,), 1.0, torch.float32, device)
        self.out_proj = _weight((d_inner, d_model), d_inner ** -0.5, generator, dtype, device)


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv1d, k=CONV_K. x: (B,S,dI); state: (B,K-1,dI),
    the last K-1 inputs before x (zeros when None).  Returns the output and
    the new state."""
    k = w.shape[0]
    pad = x.new_zeros((x.shape[0], k - 1, x.shape[2])) if state is None else state
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k)) + b
    new_state = xp[:, -(k - 1):] if k > 1 else None
    return out, new_state


def _coefficients(p, xf):
    """dt (softplus), B and C of fp32 inputs, and A = -exp(A_log)."""
    dt = F.softplus(xf @ p.w_dt.float() + p.dt_bias)
    return dt, xf @ p.w_B.float(), xf @ p.w_C.float(), -torch.exp(p.A_log)


def ssm_scan(p, x_conv):
    """x_conv: (B,S,dI) post-conv/silu -> y (B,S,dI) in its dtype and the
    last state (B,dI,N) fp32, from a zero state."""
    xf = x_conv.float()
    dt, b_mat, c_mat, a = _coefficients(p, xf)
    # time-major: a step indexes each once
    dt_t, x_t, b_t = (t.transpose(0, 1).contiguous() for t in (dt, xf, b_mat))
    decay = torch.exp(dt_t[..., None] * a)                      # (S,B,dI,N)
    drive = (dt_t * x_t)[..., None] * b_t[:, :, None, :]        # (S,B,dI,N)
    c_col = c_mat.transpose(0, 1)[..., None].contiguous()      # (S,B,N,1)
    h = drive[0]
    ys = [h @ c_col[0]]
    for t in range(1, xf.shape[1]):
        h = torch.addcmul(drive[t], decay[t], h)
        ys.append(h @ c_col[t])
    y = torch.cat(ys, dim=-1).transpose(1, 2) + p.D * xf
    return y.to(x_conv.dtype), h


def ssm_step(p, x_t, ssm_state):
    """Single decode step. x_t: (B,dI) post-conv/silu; state (B,dI,N) fp32."""
    xf = x_t.float()
    dt, bv, cv, a = _coefficients(p, xf)
    decay = torch.exp(dt[..., None] * a[None])
    h = decay * ssm_state + (dt * xf)[..., None] * bv[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, cv) + p.D * xf
    return y.to(x_t.dtype), h


def mamba(p, x, state=None):
    """Full Mamba head path. x: (B,S,d_model), or (B,1,d_model) decoding.

    state: None (train/prefill from scratch) or (conv_state, ssm_state).
    As in the reference, a decode step (S == 1) carries both, and a longer
    x takes the conv state but scans from a zero ssm state.  Returns
    (y (B,S,d_model), (conv_state, ssm_state)).
    """
    xin, z = linear(x, p.in_proj).chunk(2, dim=-1)
    # channel-TP for the recurrence: d_inner over model, the sequence whole
    if x.shape[1] > 1:
        xin = shard_hint(xin, (BATCH, None, "model"))
        z = shard_hint(z, (BATCH, None, "model"))
    conv_state, ssm_state = (None, None) if state is None else state
    xc, conv_state = _causal_conv(xin, p.conv_w, p.conv_b, conv_state)
    xc = F.silu(xc)
    if x.shape[1] == 1 and ssm_state is not None:
        y, ssm_state = ssm_step(p, xc[:, 0], ssm_state)
        y = y[:, None]
    else:
        y, ssm_state = ssm_scan(p, xc)
    y = y * F.silu(z)
    return y @ p.out_proj, (conv_state, ssm_state)


def init_mamba_state(batch: int, d_inner: int, n_state: int, dtype, device):
    return (torch.zeros((batch, CONV_K - 1, d_inner), dtype=dtype, device=device),
            torch.zeros((batch, d_inner, n_state), dtype=torch.float32, device=device))
