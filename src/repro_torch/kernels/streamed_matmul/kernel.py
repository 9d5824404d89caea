"""Binding of the CUDA GEMM (``csrc/streamed_matmul.cu``), which replaces
the Pallas TPU kernel ``mm_kernel`` of ``repro.kernels.streamed_matmul.kernel``.
fp32 runs 3xTF32 on the tensor cores: K in panels of at most 8,192, each
operand panel split into a TF32 high and low part by a pre-pass into
scratch, three products summed in fp32, which keeps fp32's accuracy.  bf16
runs on the CUDA cores.  See the source for the design."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_ARGS = (_build.PTR,) * 3 + (_build.I64,) * 3
_ARGS_F32 = (_build.PTR,) * 4 + (_build.I64,) * 3 + (_build.PTR,)
_ARGS_SPLIT = (_build.PTR,) * 3 + (_build.I64,) * 5
_ENTRY = {torch.float32: "um_gemm_f32", torch.bfloat16: "um_gemm_bf16"}
DTYPES = tuple(_ENTRY)


@functools.cache
def _scratch_bytes():
    fn = _build.library().um_gemm_f32_scratch_bytes
    fn.argtypes = [_build.I64] * 3
    fn.restype = _build.I64
    return fn


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> int:
    """c = a @ b for checked (M, K) and (K, N) inputs with M, N > 0; returns
    the number of kernels launched.

    fp32 also takes split scratch for one K panel, 2 (M_p + N_p) K_c floats
    with M_p, N_p rounded up to 128 and K_c <= 8,192 (3.7 GB at M = N = K =
    33,842, beside the 13.7 GB of a, b and c)."""
    (M, K), N = a.shape, b.shape[1]
    if a.dtype == torch.bfloat16:
        _build.launch(_ENTRY[a.dtype], _ARGS, a.data_ptr(), b.data_ptr(),
                      c.data_ptr(), M, N, K, device=a.device)
        return 1
    # one panel's split operands: A_hi, A_lo (M_p, K_c), B^T_hi, B^T_lo (N_p, K_c)
    scratch = torch.empty(_scratch_bytes()(M, N, K) // 4, dtype=torch.float32,
                          device=a.device)
    launched = ctypes.c_int64(0)
    _build.launch("um_gemm_f32", _ARGS_F32, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                  scratch.data_ptr(), M, N, K, ctypes.addressof(launched),
                  device=a.device)
    return launched.value


def split_tf32_cuda(x: torch.Tensor, transpose: bool, rows: int, cols: int):
    """The GEMM's split pre-pass alone: (hi, lo) of a checked (R, C) fp32
    matrix, or of its transpose, zero-padded to (rows, cols)."""
    src_r, src_c = x.shape
    R, C = (src_c, src_r) if transpose else (src_r, src_c)
    hi = torch.empty((rows, cols), dtype=torch.float32, device=x.device)
    lo = torch.empty_like(hi)
    _build.launch("um_split_tf32", _ARGS_SPLIT, x.data_ptr(), hi.data_ptr(),
                  lo.data_ptr(), R, C, rows, cols, int(transpose), device=x.device)
    return hi, lo
