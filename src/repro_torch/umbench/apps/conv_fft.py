"""conv0/conv1/conv2: FFT-based image convolution (paper Table I), computed
for real in plain PyTorch; ``torch.fft`` is the counterpart of the JAX side's
``jnp.fft``."""
from __future__ import annotations

import torch

from repro_torch.device import resolve


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
