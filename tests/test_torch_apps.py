"""The port's ``numeric()`` entry points (``repro_torch.umbench.apps``) on
the CPU, each with the inputs it returns fed through the JAX package's path
for the same app, at the tolerances of tests/test_kernels.py and
tests/test_umbench_numeric.py."""
import networkx as nx
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import kernels as jk  # noqa: E402
from repro.kernels.fdtd3d.ref import fdtd3d_ref  # noqa: E402
from repro.umbench.apps import bfs as jbfs  # noqa: E402
from repro.umbench.apps import cg as jcg  # noqa: E402
from repro.umbench.apps import conv_fft as jconv  # noqa: E402
from repro_torch.umbench.apps import (  # noqa: E402
    bfs, black_scholes, cg, conv_fft, fdtd3d, matmul)


def _j(t: torch.Tensor):
    return jnp.asarray(t.numpy())


def test_bs_numeric_matches_jax():
    out = black_scholes.numeric(device="cpu")
    np.testing.assert_allclose(out["call"], out["call_ref"], atol=1e-4)
    np.testing.assert_allclose(out["put"], out["put_ref"], atol=1e-4)
    s, x, t = (out[k] for k in "sxt")
    assert 5.0 <= s.min() and s.max() < 30.0
    assert 1.0 <= x.min() and x.max() < 100.0
    assert 0.25 <= t.min() and t.max() < 10.0
    cj, pj = jk.black_scholes(_j(s), _j(x), _j(t))
    np.testing.assert_allclose(out["call"], cj, atol=1e-4)
    np.testing.assert_allclose(out["put"], pj, atol=1e-4)


def test_matmul_numeric_matches_jax():
    out = matmul.numeric(n=256, device="cpu")
    np.testing.assert_allclose(out["c"], out["c_ref"], atol=1e-2, rtol=1e-3)
    cj = jk.matmul(_j(out["a"]), _j(out["b"]))
    np.testing.assert_allclose(out["c"], cj, atol=1e-3 * np.sqrt(256), rtol=1e-2)


def test_fdtd3d_numeric_matches_jax():
    out = fdtd3d.numeric(shape=(8, 16, 136), steps=2, device="cpu")
    np.testing.assert_allclose(out["out"], out["ref"], atol=1e-3)
    np.testing.assert_allclose(out["coeffs"], [0.55, 0.1, 0.02, 0.008, 0.002])
    grid, coeffs = _j(out["grid"]), _j(out["coeffs"])
    np.testing.assert_allclose(out["out"], jk.fdtd3d_run(grid, coeffs, steps=2),
                               atol=1e-3)
    ref = grid
    for _ in range(2):
        ref = fdtd3d_ref(jnp.pad(ref, 4, mode="edge"), coeffs)
    np.testing.assert_allclose(out["ref"], ref, atol=1e-3)


def test_cg_numeric_matches_jax():
    n = 128
    out = cg.numeric(n=n, device="cpu")
    assert float(out["residual"]) < 1e-6
    np.testing.assert_allclose(out["Ax"], out["b"], atol=1e-3)
    data, idx, ptr = jcg.laplacian_csr(n)
    xj, resj = jcg.cg_solve(data, idx, ptr, _j(out["b"]), iters=2 * n)
    assert float(resj) < 1e-6
    # both solve L x = b; L's condition number (~n^2) scales fp32 rounding
    scale = float(np.abs(np.asarray(xj)).max())
    np.testing.assert_allclose(out["x"], xj, atol=1e-4 * scale)


def test_cg_csr_matches_jax():
    data, idx, ptr = cg.laplacian_csr(9, "cpu")
    jd, ji, jp = jcg.laplacian_csr(9)
    np.testing.assert_array_equal(data, jd)
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_array_equal(ptr, jp)


def test_bfs_numeric_matches_jax_and_networkx():
    out = bfs.numeric(n=48, avg_deg=3, device="cpu")
    jout = jbfs.numeric(None, n=48, avg_deg=3)
    assert out["edges"] == [tuple(map(int, e)) for e in jout["edges"]]
    got = out["level"].numpy()
    np.testing.assert_array_equal(got, np.asarray(jout["level"]))
    g = nx.Graph()
    g.add_nodes_from(range(out["n"]))
    g.add_edges_from(out["edges"])
    expect = nx.single_source_shortest_path_length(g, 0)
    assert got.tolist() == [expect.get(v, -1) for v in range(out["n"])]


def test_bfs_levels_unreachable():
    """Isolated nodes keep level -1 (JAX bfs_levels on the same CSR)."""
    ptr, idx = [0, 1, 2, 2, 2], [1, 0]
    got = bfs.bfs_levels(ptr, idx, 0, 4, 1, "cpu")
    np.testing.assert_array_equal(got, jbfs.bfs_levels(ptr, idx, 0, 4, 1))
    assert got.tolist() == [0, 1, -1, -1]


@pytest.mark.parametrize("real", [True, False])
def test_conv_numeric_matches_jax(real):
    out = conv_fft.numeric(n=32, real=real, device="cpu")
    np.testing.assert_allclose(out["out"], out["ref"], atol=1e-3)
    img, kern = _j(out["img"]), _j(out["kern"])
    np.testing.assert_allclose(out["out"], jconv.fft_convolve_2d(img, kern, real=real),
                               atol=1e-3)
    np.testing.assert_allclose(out["ref"], jconv.direct_convolve_2d(img, kern),
                               atol=1e-3)
