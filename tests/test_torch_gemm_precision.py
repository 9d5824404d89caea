"""The numerical argument behind the port's fp32 GEMM kernel, which runs
3xTF32 on the tensor cores (``csrc/streamed_matmul.cu``), emulated in plain
PyTorch on the CPU at the kernel tests' shapes.

Each fp32 operand x is split into x_hi = tf32(x) and x_lo = tf32(x - x_hi)
(``split_tf32_ref``, the plain version of the kernel's pre-pass), and
A B ~ A_lo B_hi + A_hi B_lo + A_hi B_hi.  A product of two TF32 values is
exact in fp32, so three fp32 products of the parts emulate the tensor
cores' products (not their order of summation).  Against fp64, the
emulation must stay within GEMM_FP64_FACTOR times the error of a plain fp32
product, the limit ``chip_smoke.py`` holds the kernel to at full size, and
within the JAX tests' tolerance of ``repro.kernels.matmul``; a one-pass
TF32 product, or one that drops A_lo B_hi, must fail that limit."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import kernels as jk  # noqa: E402
from repro_torch.kernels.streamed_matmul.ref import (  # noqa: E402
    split_tf32_ref, tf32_round)


def _load_chip_smoke():
    """chip_smoke.py, whose fp64 limit the tests below hold to."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SHAPES = [(300, 700, 250), (256, 512, 128)]
GEMM_FP64_FACTOR = _load_chip_smoke().GEMM_FP64_FACTOR
THREE_TERMS = ("lo_hi", "hi_lo", "hi_hi")  # in the kernel's order


def _inputs(m, k, n):
    rng = np.random.default_rng(m * k * n)
    return (torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)))


def _emulate(a, b, terms):
    """The sum of the named products of TF32 parts, each in fp32."""
    (a_hi, a_lo), (b_hi, b_lo) = split_tf32_ref(a), split_tf32_ref(b)
    parts = {"lo_hi": (a_lo, b_hi), "hi_lo": (a_hi, b_lo), "hi_hi": (a_hi, b_hi)}
    out = torch.zeros((a.shape[0], b.shape[1]))
    for t in terms:
        x, y = parts[t]
        out += x @ y
    return out


def _fp64_limit(a, b):
    """(fp64 product, GEMM_FP64_FACTOR x the largest error of fp32's)."""
    want = a.double() @ b.double()
    return want, GEMM_FP64_FACTOR * (a @ b - want).abs().max().item()


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_3xtf32_meets_the_fp64_limit(m, k, n):
    a, b = _inputs(m, k, n)
    want, limit = _fp64_limit(a, b)
    err = (_emulate(a, b, THREE_TERMS) - want).abs().max().item()
    assert err <= limit, (err, limit)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_3xtf32_meets_the_jax_tolerance(m, k, n):
    a, b = _inputs(m, k, n)
    out_j = jk.matmul(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    np.testing.assert_allclose(_emulate(a, b, THREE_TERMS).numpy(),
                               np.asarray(out_j, np.float32),
                               atol=1e-3 * np.sqrt(k), rtol=1e-2)


@pytest.mark.parametrize("terms", [("hi_hi",), ("hi_lo", "hi_hi")],
                         ids=["one_pass_tf32", "without_a_lo_b_hi"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_the_fp64_limit_rejects_fewer_terms(m, k, n, terms):
    a, b = _inputs(m, k, n)
    want, limit = _fp64_limit(a, b)
    err = (_emulate(a, b, terms) - want).abs().max().item()
    assert err > 10 * limit, (err, limit)


def test_split_parts_are_tf32_and_sum_to_x():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    x = x * torch.logspace(-20, 20, 4096, base=2.0)
    hi, lo = split_tf32_ref(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()  # low 13 bits zero
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
    assert rel <= 2.0**-22
    assert ((hi.double() - x.double()).abs() / x.double().abs()).max() <= 2.0**-11


def test_tf32_round_is_nearest_ties_away_from_zero():
    one = 1.0
    x = torch.tensor([one + 2**-11, -(one + 2**-11), one + 2**-11 - 2**-23,
                      one + 3 * 2**-11, 0.0, float("inf")])
    want = [one + 2**-10, -(one + 2**-10), one, one + 2**-9, 0.0, float("inf")]
    assert tf32_round(x).tolist() == want


def test_products_of_tf32_values_are_exact_in_fp32():
    rng = np.random.default_rng(1)
    x, y = (tf32_round(torch.from_numpy(rng.standard_normal(4096).astype(np.float32)))
            for _ in range(2))
    assert torch.equal((x * y).double(), x.double() * y.double())
