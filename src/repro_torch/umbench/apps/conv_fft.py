"""conv0/conv1/conv2 — FFT-based image convolution (paper Table I).

conv0 uses Real-to-Complex / Complex-to-Real plans (frequency buffers ~half
the complex size); conv1/conv2 use Complex-to-Complex plans with different
buffer splits.  Advise: PREFERRED_LOCATION(DEVICE) on the frequency
workspaces (GPU-private), READ_MOSTLY on the kernel image.  Prefetch: the
input image + kernel.  ``workload()`` builds the
traces; variant lowering lives in ``umbench.variants``.

``numeric()`` computes it for real in plain PyTorch; ``torch.fft`` is the
counterpart of the JAX side's ``jnp.fft``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.advise import MemorySpace
from repro_torch.device import resolve
from repro_torch.umbench.workload import Workload, WorkloadBuilder

ITERS = 4

# (img, kern_img, freq_img, freq_kern, out) fractions per variant
SPLITS = {
    "conv0": (0.28, 0.02, 0.22, 0.20, 0.28),   # R2C/C2R: half-size freq
    "conv1": (0.20, 0.02, 0.29, 0.29, 0.20),   # C2C
    "conv2": (0.22, 0.02, 0.27, 0.27, 0.22),   # C2C, second geometry
}


def make_workload(kind: str):
    fr = SPLITS[kind]

    def workload(total_bytes: float, iters: int = ITERS) -> Workload:
        w = WorkloadBuilder(kind)
        names = ("img", "kern_img", "freq_img", "freq_kern", "out")
        for nm, f in zip(names, fr, strict=True):
            w.alloc(nm, int(total_bytes * f), role="conv")
        w.host_write("img")
        w.host_write("kern_img")

        w.advise_preferred_location("freq_img", MemorySpace.DEVICE)
        w.advise_preferred_location("freq_kern", MemorySpace.DEVICE)
        w.advise_read_mostly("kern_img")
        w.prefetch("img", "kern_img")

        n = int(total_bytes * fr[0]) / 8  # complex64 elements
        fft_flops = 5.0 * n * max(1.0, math.log2(max(n, 2)))
        w.kernel("fft_kern", flops=fft_flops * 0.1,
                 reads=("kern_img",), writes=("freq_kern",))
        for _ in range(iters):
            w.kernel("fft_fwd", flops=fft_flops, reads=("img",),
                     writes=("freq_img",))
            w.kernel("pointwise", flops=6.0 * n,
                     reads=("freq_img", "freq_kern"), writes=("freq_img",))
            w.kernel("fft_inv", flops=fft_flops, reads=("freq_img",),
                     writes=("out",))
        w.readback("out")
        return w.build()

    return workload


def fft_convolve_2d(img, kern, *, real: bool):
    """Circular FFT convolution: real-to-complex plans (conv0) when
    ``real``, else complex-to-complex (conv1/conv2)."""
    if real:
        fi = torch.fft.rfft2(img)
        fk = torch.fft.rfft2(kern, s=img.shape)
        return torch.fft.irfft2(fi * fk, s=img.shape)
    fi = torch.fft.fft2(img.to(torch.complex64))
    fk = torch.fft.fft2(kern.to(torch.complex64), s=img.shape)
    return torch.fft.ifft2(fi * fk).real


def direct_convolve_2d(img, kern):
    """O(n^2 k^2) circular convolution for small-size validation."""
    out = torch.zeros_like(img)
    kh, kw = kern.shape
    for i in range(kh):
        for j in range(kw):
            out = out + kern[i, j] * torch.roll(img, (i, j), dims=(0, 1))
    return out


def numeric(seed: int = 0, n: int = 32, real: bool = True, device=None):
    """Convolve an N(0, 1) n x n image with an N(0, 1) 5 x 5 kernel, by FFT
    and directly."""
    dev = resolve(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    img = torch.randn(n, n, generator=g, device=dev)
    kern = torch.randn(5, 5, generator=g, device=dev)
    return {"img": img, "kern": kern,
            "out": fft_convolve_2d(img, kern, real=real),
            "ref": direct_convolve_2d(img, kern)}
