"""Gradient compression for the inter-pod all-reduce (DESIGN.md §6): the
counterpart of ``repro.runtime.compression``.

int8 absmax quantization with error feedback (EF-SGD style): the
quantization residual is carried into the next step, so the compressed
all-reduce is unbiased in the long run and converges at the uncompressed
rate for smooth objectives.  It quarters (fp32) or halves (bf16) the
bytes on the slow links between pods; the gradient all-reduce is the only
collective that crosses them in this layout.

``compressed_psum`` runs over a process group (a mesh axis's:
``mesh.get_group(axis)``; None, the world): MAX of the local scales, SUM of the int8 codes as int32, division
by the group's size.  The rounding is half to even, as ``jnp.round``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed import _functional_collectives as funcol


def quantize_int8(x):
    """(values int8, scale fp32). Per-tensor absmax."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compress_with_feedback(grad, error):
    """-> (q, scale, new_error). new_error = grad+error - dequant(q)."""
    g = grad.to(torch.float32) + error
    q, scale = quantize_int8(g)
    return q, scale, g - dequantize_int8(q, scale)


def compressed_psum(x, group, error):
    """Mean-all-reduce ``x`` over ``group`` in int8 with error feedback ->
    (mean in x's dtype, new error fp32).

    The integer sum is exact (int8 -> int32 accumulate); the scale is
    shared by a MAX so every rank quantizes onto the same grid and
    dequantizes identically."""
    pg = group if group is not None else dist.group.WORLD
    g = x.to(torch.float32) + error
    local_scale = torch.clamp(g.abs().amax(), min=1e-12) / 127.0
    scale = funcol.all_reduce(local_scale, "max", pg)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    new_error = g - q.to(torch.float32) * scale
    total = funcol.all_reduce(q.to(torch.int32), "sum", pg)
    n = torch.tensor(float(dist.get_world_size(pg)), dtype=torch.float32, device=x.device)
    mean = total.to(torch.float32) * scale / n
    return mean.to(x.dtype), new_error


def tree_compressed_psum(grads: dict, group, errors: dict):
    """``compressed_psum`` over a dict of gradients (a parameter name ->
    tensor, as the train step holds them); ``errors`` has the same keys."""
    out_g, out_e = {}, {}
    for name, g in grads.items():
        out_g[name], out_e[name] = compressed_psum(g, group, errors[name])
    return out_g, out_e


def init_error_feedback(grads: dict) -> dict:
    return {name: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for name, g in grads.items()}
