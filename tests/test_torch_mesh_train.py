"""The port's sharded train and decode steps on a (2, 2) gloo mesh of four
CPU processes against the JAX package's unsharded steps.

Reduced qwen2-7b, mixtral-8x22b and rwkv6-3b (the configs of
tests/test_sharding_subproc.py) with JAX's weights carried across by
``params_from_jax``; batches, caches and tokens seeded with NumPy.  One
module fixture writes the inputs, starts the four ranks
(tests/_torch_mesh_worker.py) with their own ``FileStore`` and a join
timeout, and computes JAX's side.

Tolerances are tests/test_torch_train.py's: one train step's loss, grad
norm, lr and parameters at 1e-5, weights whose gradient is below 1e-6 but
not 0 within twice the lr; decode logits and caches at 1e-5.  The fault
(each rank's unreduced ``Partial`` gradient applied as if it were the
sum) must fail that same comparison."""
import dataclasses
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
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.launch import step as jstep  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_torch_mesh_worker.py"
ARCHS = ("qwen2-7b", "mixtral-8x22b", "rwkv6-3b")
TRAIN = [(a, "2d") for a in ARCHS] + [("qwen2-7b", "fsdp"), ("qwen2-7b", "zero1")]
STEP_TOL = 1e-5
TINY_GRAD = 1e-6
TRAIN_KW = {"warmup_steps": 2, "learning_rate": 3e-3, "microbatches": 1}
B, S, DECODE_S, CACHE_LEN = 4, 32, 32, 20
JOIN_TIMEOUT = 300


def _jarch(name):
    a = jconfigs.get_config(name)
    return dataclasses.replace(a, model=a.model.reduce(),
                               train=dataclasses.replace(a.train, **TRAIN_KW))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cases():
    cases, want = [], {}
    for i, name in enumerate(ARCHS):
        arch = _jarch(name)
        cfg = arch.model
        tree = jax.jit(lambda k: jt.init_params(k, cfg))(jax.random.key(10 + i))
        rng = np.random.default_rng(20 + i)
        toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
        state = jadamw.init_state(tree, jstep._adamw_cfg(arch, None))
        fn = jax.jit(jstep.build_train_step(arch, JShape("t", S, B, "train"), None, None,
                                            total_steps=10))
        p1, _, m = fn(tree, state, jax.tree.map(jnp.asarray, batch), jnp.int32(5))
        grads = jax.jit(jax.grad(lambda p: jt.loss_fn(p, jax.tree.map(jnp.asarray, batch),
                                                      cfg)))(tree)
        ref = {"metrics": {k: float(v) for k, v in m.items()},
               "params": _np_tree(p1), "grads": _np_tree(grads)}
        for n, mode in TRAIN:
            if n == name:
                cases.append({"name": f"train/{name}/{mode}", "kind": "train", "arch": name,
                              "mode": mode, "train": TRAIN_KW, "params": _np_tree(tree),
                              "batch": batch, "B": B, "S": S})
                want[cases[-1]["name"]] = ref
        if name == "qwen2-7b":
            cases.append(dict(cases[-1], name=f"fault/{name}/2d", mode="2d", fault=True))
            want[cases[-1]["name"]] = ref
        # decode: seeded caches of DECODE_S positions, CACHE_LEN of them filled
        caches = jax.eval_shape(lambda: jt.init_caches(cfg, B, DECODE_S))
        caches = {k: rng.standard_normal(v.shape).astype(v.dtype) * 0.5
                  for k, v in caches.items()}
        tokens = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
        logits, new = jax.jit(lambda p, c, t: jt.decode_step(p, {"tokens": t}, c,
                                                             jnp.int32(CACHE_LEN), cfg))(
            tree, jax.tree.map(jnp.asarray, caches), jnp.asarray(tokens))
        cases.append({"name": f"decode/{name}", "kind": "decode", "arch": name,
                      "train": TRAIN_KW, "params": _np_tree(tree), "caches": caches,
                      "tokens": tokens, "cache_len": CACHE_LEN})
        want[cases[-1]["name"]] = {"logits": np.asarray(logits), "caches": _np_tree(new)}
    return cases, want


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start the four ranks once for the module; each has its own
    rendezvous file and the join a timeout, so a hang fails here."""
    tmp = tmp_path_factory.mktemp("mesh")
    cases, want = _cases()
    (tmp / "cases.pkl").write_bytes(pickle.dumps(cases))
    store = tmp / "store"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), "4", str(store),
                               str(tmp), str(tmp)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
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
    got = pickle.loads((tmp / "out.pkl").read_bytes())
    return {c["name"]: c for c in cases}, want, got


def _unstack(tree) -> dict:
    """JAX's tree as the port's {name: array}: layers/<path>[i] is
    blocks.<i>.<path>."""
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        keys = [p.key for p in path]
        if keys[0] == "layers":
            for i in range(leaf.shape[0]):
                out[".".join(["blocks", str(i)] + keys[1:])] = np.asarray(leaf[i])
        else:
            out[".".join(keys)] = np.asarray(leaf)
    return out


def _train_errors(got: dict, want: dict) -> list[str]:
    """What fails test_torch_train's comparison of one step."""
    bad = []
    for k in ("loss", "grad_norm", "lr"):
        if got["metrics"][k] != pytest.approx(want["metrics"][k], rel=STEP_TOL):
            bad.append(k)
    lr = want["metrics"]["lr"]
    params, grads = _unstack(want["params"]), _unstack(want["grads"])
    assert set(params) == set(got["params"])
    for n, w in params.items():
        g = got["params"][n].astype(np.float64)
        w, gr = w.astype(np.float64), grads[n].astype(np.float64)
        tiny = (np.abs(gr) < TINY_GRAD) & (gr != 0)
        if np.any(np.abs(g[tiny] - w[tiny]) > 2 * lr) or not np.allclose(
                g[~tiny], w[~tiny], rtol=STEP_TOL, atol=STEP_TOL):
            bad.append(n)
    return bad


@pytest.mark.parametrize("arch,mode", TRAIN)
def test_sharded_train_step_matches_jax(run, arch, mode):
    cases, want, got = run
    name = f"train/{arch}/{mode}"
    assert _train_errors(got[name], want[name]) == []


@pytest.mark.parametrize("arch,mode", TRAIN)
def test_train_step_reduces_gradients(run, arch, mode):
    """The step's counted collectives hold a gradient all-reduce or
    reduce-scatter, and every parameter comes back sharded as placed."""
    _, _, got = run
    counts = got[f"train/{arch}/{mode}"]["collectives"]["counts"]
    assert counts.get("all-reduce", 0) + counts.get("reduce-scatter", 0) > 0, counts
    assert not any("Partial" in p for p in got[f"train/{arch}/{mode}"]["grad_placements"])


def test_unreduced_gradient_fails_the_comparison(run):
    """Applying each rank's Partial gradient as if it were reduced trains
    another model: the same comparison must reject it."""
    _, want, got = run
    bad = _train_errors(got["fault/qwen2-7b/2d"], want["fault/qwen2-7b/2d"])
    assert len(bad) > 1, bad


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_step_matches_jax(run, arch):
    """One decode step on the mesh, caches sequence- (or channel-) sharded
    over model as cache_specs place them: logits and the caches it wrote,
    and the serve step's greedy tokens."""
    _, want, got = run
    g, w = got[f"decode/{arch}"], want[f"decode/{arch}"]
    np.testing.assert_allclose(g["logits"], w["logits"], rtol=STEP_TOL, atol=STEP_TOL)
    for k, v in w["caches"].items():
        np.testing.assert_allclose(g["caches"][k], np.asarray(v, np.float32),
                                   rtol=STEP_TOL, atol=STEP_TOL, err_msg=k)
    assert "Shard" in " ".join(g["cache_placements"].values())
    np.testing.assert_array_equal(g["next_tokens"], w["logits"].argmax(-1))
