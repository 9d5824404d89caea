"""The port's gradient compression, decode combine over a mesh axis and
elastic re-mesh planning against the JAX package.

``quantize_int8``, ``dequantize_int8`` and ``compress_with_feedback`` bit
for bit (the same fp32 arithmetic, rounding half to even on both sides).
``compressed_psum`` over a gloo group of four CPU processes against JAX's
under ``jax.vmap(..., axis_name="pod")`` on the stacked inputs: the int8
codes equal, the mean and the new error within 1e-6.
``combine_decode_partials`` over the "model" axis of a (2, 2) gloo mesh
against JAX's under vmap at 1e-6.  ``plan_elastic_mesh`` exactly."""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import residency as jres  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.runtime import compression as jcomp  # noqa: E402
from repro.runtime import elastic as jel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    compress_with_feedback,
    dequantize_int8,
    init_error_feedback,
    plan_elastic_mesh,
    quantize_int8,
)

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
TOL = 1e-6
JOIN_TIMEOUT = 180

WORKER = r"""
import pickle, sys
from pathlib import Path
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
from repro_torch.launch.mesh import make_test_mesh, mesh_context
from repro_torch.models.attention import combine_decode_partials
from repro_torch.runtime import compressed_psum, tree_compressed_psum
inp = pickle.loads((tmp / "in.pkl").read_bytes())
out = {}
for name, (x, e) in inp["psum"].items():
    mean, err = compressed_psum(torch.from_numpy(x[rank]), None, torch.from_numpy(e[rank]))
    out[name] = (mean.float().numpy(), err.numpy())
tree, errs = tree_compressed_psum({k: torch.from_numpy(v[0][rank]) for k, v in inp["psum"].items()},
                                  dist.group.WORLD,
                                  {k: torch.from_numpy(v[1][rank]) for k, v in inp["psum"].items()})
out["tree"] = {k: (tree[k].float().numpy(), errs[k].numpy()) for k in tree}
mesh = make_test_mesh((2, 2), device_type="cpu")
d, m = mesh.get_coordinate()
num, den, mx = (torch.from_numpy(a[d, m]) for a in inp["combine"])
with mesh_context(mesh):
    out["combine"] = combine_decode_partials(num, den, mx, "model").numpy()
(tmp / f"out{rank}.pkl").write_bytes(pickle.dumps(out))
dist.destroy_process_group()
"""


def _seeded(seed, shape, scale=1.0, dtype=np.float32):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(dtype)


# ---------------------------------------------------------------------------
# Quantization and error feedback, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,scale", [((256,), 3.0), ((8, 33), 1e-3), ((4, 4, 4), 1e4),
                                         ((5,), 0.0)])
def test_quantize_matches_jax_bit_for_bit(shape, scale):
    x = _seeded(sum(shape), shape, scale)
    qj, sj = jcomp.quantize_int8(jnp.asarray(x))
    qt, st = quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert st.item() == float(sj)
    np.testing.assert_array_equal(dequantize_int8(qt, st).numpy(),
                                  np.asarray(jcomp.dequantize_int8(qj, sj)))


def test_quantize_takes_bf16_as_the_reference():
    x = _seeded(3, (64,), 2.0)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    qj, sj = jcomp.quantize_int8(xj)
    qt, st = quantize_int8(xt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert st.item() == float(sj)


def test_compress_with_feedback_matches_jax_bit_for_bit():
    err_j = jnp.zeros(64)
    err_t = torch.zeros(64)
    for i in range(20):
        g = _seeded(100 + i, (64,), 0.01)
        qj, sj, err_j = jcomp.compress_with_feedback(jnp.asarray(g), err_j)
        qt, st, err_t = compress_with_feedback(torch.from_numpy(g), err_t)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert st.item() == float(sj)
        np.testing.assert_array_equal(err_t.numpy(), np.asarray(err_j))


def test_int8_quantization_error_bound():
    x = torch.from_numpy(_seeded(0, (256,), 3.0))
    q, scale = quantize_int8(x)
    err = (dequantize_int8(q, scale) - x).abs()
    assert err.max().item() <= scale.item() / 2 + 1e-6


def test_error_feedback_accumulates_exactly():
    """EF property: sum of transmitted values -> sum of true gradients."""
    rng = np.random.default_rng(0)
    grads = [torch.from_numpy(rng.standard_normal(64).astype(np.float32) * 0.01)
             for _ in range(50)]
    err = init_error_feedback({"g": grads[0]})["g"]
    sent_total = torch.zeros(64)
    for g in grads:
        q, scale, err = compress_with_feedback(g, err)
        sent_total = sent_total + dequantize_int8(q, scale)
    true_total = sum(grads)
    # residual bounded by one quantization step, independent of #steps
    np.testing.assert_allclose((sent_total + err).numpy(), true_total.numpy(), atol=1e-5)
    assert err.abs().max().item() < 0.01


def test_compressed_training_converges():
    """SGD on a quadratic with int8+EF compressed gradients converges."""
    target = torch.from_numpy(np.random.default_rng(1).standard_normal(32).astype(np.float32))
    w = torch.zeros(32)
    err = torch.zeros(32)
    for _ in range(400):
        g = 2 * (w - target)
        q, scale, err = compress_with_feedback(g, err)
        w = w - 0.05 * dequantize_int8(q, scale)
    assert ((w - target) ** 2).mean().item() < 1e-4


# ---------------------------------------------------------------------------
# Collectives over a gloo group of four
# ---------------------------------------------------------------------------

def _psum_inputs():
    out = {}
    for i, (shape, scale) in enumerate([((64,), 0.01), ((8, 16), 3.0), ((33,), 1e3)]):
        x = np.stack([_seeded(10 * i + r, shape, scale * (r + 1)) for r in range(WORLD)])
        e = np.stack([_seeded(50 + 10 * i + r, shape, scale * 1e-3) for r in range(WORLD)])
        out[f"case{i}"] = (x, e)
    return out


def _combine_inputs():
    rng = np.random.default_rng(7)
    B, H, Dh = 2, 4, 8
    num = rng.standard_normal((2, 2, B, H, Dh)).astype(np.float32)
    den = rng.uniform(0.5, 3.0, (2, 2, B, H)).astype(np.float32)
    m = rng.standard_normal((2, 2, B, H)).astype(np.float32) * 4
    return num, den, m


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Four gloo ranks, their own rendezvous file, a join timeout."""
    tmp = tmp_path_factory.mktemp("gloo")
    inp = {"psum": _psum_inputs(), "combine": _combine_inputs()}
    (tmp / "in.pkl").write_bytes(pickle.dumps(inp))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(WORLD),
                               str(tmp / "store"), str(tmp)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(x[-3000:] for x in logs)
    return inp, [pickle.loads((tmp / f"out{r}.pkl").read_bytes()) for r in range(WORLD)]


def _codes(x, e, new_err):
    """The int8 codes a rank sent: (x + e - new_error) / scale, the scale
    the group's MAX of the local absmax scales."""
    g = x.astype(np.float32) + e
    scale = np.float32(max(np.maximum(np.abs(gi).max(), np.float32(1e-12)) for gi in g)
                       / np.float32(127.0))
    return np.round((g - new_err) / scale).astype(np.int64)


@pytest.mark.parametrize("case", ["case0", "case1", "case2"])
def test_compressed_psum_matches_jax_under_vmap(gloo, case):
    inp, outs = gloo
    x, e = inp["psum"][case]
    mean_j, err_j = jax.vmap(lambda a, b: jcomp.compressed_psum(a, "pod", b),
                             axis_name="pod")(jnp.asarray(x), jnp.asarray(e))
    mean_j, err_j = np.asarray(mean_j), np.asarray(err_j)
    for r, out in enumerate(outs):
        for got_mean, got_err in (out[case], out["tree"][case]):
            np.testing.assert_allclose(got_mean, mean_j[r], rtol=TOL, atol=TOL)
            np.testing.assert_allclose(got_err, err_j[r], rtol=TOL, atol=TOL)
    got_err = np.stack([out[case][1] for out in outs])
    np.testing.assert_array_equal(_codes(x, e, got_err), _codes(x, e, err_j))


def test_compressed_psum_mean_is_within_a_step_of_the_plain_mean(gloo):
    """The int8 mean differs from the plain mean of x + e by at most one
    quantisation step of the shared scale."""
    inp, outs = gloo
    for case, (x, e) in inp["psum"].items():
        g = x.astype(np.float64) + e
        scale = max(np.abs(gi).max() for gi in g) / 127.0
        np.testing.assert_array_less(np.abs(outs[0][case][0] - g.mean(0)), scale + 1e-6)


def test_combine_decode_partials_over_a_mesh_axis_matches_jax(gloo):
    """Each rank of the (2, 2) mesh holds the partials of one sequence
    shard; the combine over "model" merges the two shards of its data row."""
    inp, outs = gloo
    num, den, m = inp["combine"]
    comb = jax.vmap(jax.vmap(lambda a, b, c: jattn.combine_decode_partials(a, b, c, "model"),
                             axis_name="model"))
    want = np.asarray(comb(jnp.asarray(num), jnp.asarray(den), jnp.asarray(m)))
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["combine"], want[r // 2, r % 2], rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# Elastic re-mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_plan_elastic_mesh_matches_jax(arch):
    hbm = jres.HBM_PER_DEVICE_BYTES
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        for survivors in (8, 64, 240, 256):
            want = jel.plan_elastic_mesh(jconfigs.get_config(arch), jconfigs.get_shape(shape),
                                         survivors, hbm_bytes=hbm)
            got = plan_elastic_mesh(tconfigs.get_config(arch), tconfigs.get_shape(shape),
                                    survivors, hbm_bytes=hbm)
            assert json.dumps(got.__dict__) == json.dumps(want.__dict__), (shape, survivors)


def test_elastic_shrink_keeps_tp():
    d = plan_elastic_mesh(tconfigs.get_config("qwen2-72b"), tconfigs.get_shape("train_4k"),
                          surviving_devices=240, hbm_bytes=jres.HBM_PER_DEVICE_BYTES)
    assert d.model == 16 and d.data == 15
    assert d.global_batch % d.data == 0


def test_elastic_needs_hbm_bytes_on_the_cpu():
    with pytest.raises(ValueError, match="hbm_bytes"):
        plan_elastic_mesh(tconfigs.get_config("starcoder2-3b"), tconfigs.get_shape("train_4k"),
                          8, device="cpu")
