"""The port's kernel wrappers (``repro_torch.kernels``) against the JAX
package's kernels on the same seeded inputs, at the tolerances of
tests/test_kernels.py.  On the CPU the port's wrappers take their plain
PyTorch versions; the JAX kernels run as their own tests run them (Pallas
interpret mode).  The CUDA kernels themselves are held against the same
plain versions on the card by chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # collection must not error (dev-only dependency)
    from _hypothesis_fallback import given, settings, st

from repro import kernels as jk  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.interop import to_torch  # noqa: E402


def _f32(a) -> np.ndarray:
    """Values of a torch tensor or JAX array as a float32 numpy array."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# Black-Scholes
# ---------------------------------------------------------------------------

def _options(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.uniform(5.0, 30.0, n).astype(np.float32),
            rng.uniform(1.0, 100.0, n).astype(np.float32),
            rng.uniform(0.25, 10.0, n).astype(np.float32))


@pytest.mark.parametrize("n", [7, 128, 1000, 4096])
def test_black_scholes_matches_jax(n):
    s, x, t = _options(n, seed=n)
    cj, pj = jk.black_scholes(*map(jnp.asarray, (s, x, t)))
    ct, pt = tk.black_scholes(*to_torch((s, x, t), "cpu"))
    np.testing.assert_allclose(_f32(ct), _f32(cj), atol=1e-4)
    np.testing.assert_allclose(_f32(pt), _f32(pj), atol=1e-4)


@settings(max_examples=25, deadline=None)
@given(
    spot=st.floats(1.0, 500.0), strike=st.floats(1.0, 500.0),
    t=st.floats(0.05, 20.0), r=st.floats(0.0, 0.2), v=st.floats(0.05, 1.0),
)
def test_black_scholes_properties(spot, strike, t, r, v):
    """Put-call parity and call in [S - K e^-rt, S], on the port."""
    def full(val):
        return torch.full((128,), val, dtype=torch.float32)

    c, p = tk.black_scholes(full(spot), full(strike), full(t), r=r, v=v)
    c, p = float(c[0]), float(p[0])
    parity = c - p - (spot - strike * np.exp(-r * t))
    assert abs(parity) < 1e-2 * max(1.0, spot, strike)
    assert c >= max(0.0, spot - strike * np.exp(-r * t)) - 1e-2
    assert c <= spot + 1e-2


# ---------------------------------------------------------------------------
# Streamed matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (300, 700, 250), (256, 512, 128)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_matmul_matches_jax(m, k, n, dtype):
    rng = np.random.default_rng(m * k * n)
    a = np.asarray(jnp.asarray(rng.standard_normal((m, k)), dtype))
    b = np.asarray(jnp.asarray(rng.standard_normal((k, n)), dtype))
    out_j = jk.matmul(jnp.asarray(a), jnp.asarray(b))
    at, bt = to_torch((a, b), "cpu")
    out_t = tk.matmul(at, bt)
    assert out_t.dtype == at.dtype
    atol = 1e-3 if dtype == jnp.float32 else 0.15
    np.testing.assert_allclose(_f32(out_t), _f32(out_j),
                               atol=atol * np.sqrt(k), rtol=1e-2)


# ---------------------------------------------------------------------------
# FDTD3d
# ---------------------------------------------------------------------------

COEF = np.array([0.5, 0.1, 0.05, 0.02, 0.01], np.float32)


@pytest.mark.parametrize("shape", [(8, 16, 128), (16, 24, 136), (24, 8, 256)])
def test_fdtd3d_step_matches_jax(shape):
    g = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    out_j = jk.fdtd3d_step(jnp.asarray(g), jnp.asarray(COEF))
    out_t = tk.fdtd3d_step(*to_torch((g, COEF), "cpu"))
    np.testing.assert_allclose(_f32(out_t), _f32(out_j), atol=1e-4)


def test_fdtd3d_run_matches_jax():
    g = np.random.default_rng(3).standard_normal((16, 24, 136)).astype(np.float32)
    out_j = jk.fdtd3d_run(jnp.asarray(g), jnp.asarray(COEF), steps=2)
    gt, ct = to_torch((g, COEF), "cpu")
    out_t = tk.fdtd3d_run(gt, ct, steps=2)
    np.testing.assert_allclose(_f32(out_t), _f32(out_j), atol=1e-3)
    np.testing.assert_array_equal(gt.numpy(), g)  # the input is left as it was


def test_fdtd3d_constant_field_invariant():
    """out = c0*x + sum_r c_r*6x for a constant field."""
    coef = torch.tensor([0.4, 0.05, 0.03, 0.015, 0.005])
    out = tk.fdtd3d_step(torch.full((8, 16, 128), 2.5), coef)
    factor = float(coef[0] + 6 * coef[1:].sum())
    np.testing.assert_allclose(out.numpy(), 2.5 * factor, rtol=1e-5)


def _stencil_clamped(g: np.ndarray) -> np.ndarray:
    """The stencil step in numpy, every neighbour index clamped to the grid."""
    idx = [np.clip(np.arange(-4, d + 4), 0, d - 1) for d in g.shape]
    p = g[np.ix_(*idx)]
    want = COEF[0] * g
    Z, Y, X = g.shape
    for r in range(1, 5):
        want = want + COEF[r] * (
            p[4 - r:4 - r + Z, 4:4 + Y, 4:4 + X] + p[4 + r:4 + r + Z, 4:4 + Y, 4:4 + X]
            + p[4:4 + Z, 4 - r:4 - r + Y, 4:4 + X] + p[4:4 + Z, 4 + r:4 + r + Y, 4:4 + X]
            + p[4:4 + Z, 4:4 + Y, 4 - r:4 - r + X] + p[4:4 + Z, 4:4 + Y, 4 + r:4 + r + X])
    return want


def test_fdtd3d_any_z_and_tiny_dims():
    """The port drops the Pallas kernel's Z % 8 constraint: the plain
    version clamps to the edge on every axis, however short."""
    g = np.random.default_rng(5).standard_normal((5, 3, 40)).astype(np.float32)
    out = tk.fdtd3d_step(*to_torch((g, COEF), "cpu")).numpy()
    np.testing.assert_allclose(out, _stencil_clamped(g), atol=1e-5)


@pytest.mark.parametrize("shape", [(7, 19, 1001), (9, 5, 3), (3, 70, 65)])
def test_fdtd3d_shapes_that_cut_the_kernel_tile(shape):
    """The shapes chip_smoke.py holds the CUDA kernel to its plain version
    at, which cut its 16 x 64 tile and its ring of z planes (X not a
    multiple of 4, Y and X below the halo, X one past a tile): the plain
    version against the stencil with clamped indices."""
    g = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    out = tk.fdtd3d_step(*to_torch((g, COEF), "cpu")).numpy()
    np.testing.assert_allclose(out, _stencil_clamped(g), atol=1e-5)
