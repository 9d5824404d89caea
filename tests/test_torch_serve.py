"""The port's serving entry point (``repro_torch.launch.serve``) against
the JAX package's ``repro.launch.serve`` on reduced configs, with the JAX
weights carried across (``params=``).  The port is teacher-forced with the
tokens JAX's serve generated, so that one near-tie cannot derail the rest;
its prefill logits and each decode step's logits then match the reference
path's at 1e-4 (fp32), and its tokens equal JAX's wherever JAX's top two
logits are more than 1e-3 apart."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.step import build_prefill_step as jbuild_prefill_step  # noqa: E402
from repro.launch.step import build_serve_step as jbuild_serve_step  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import prefetched  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.launch import step as tstep  # noqa: E402
from repro_torch.launch.serve import main, serve  # noqa: E402

B, PROMPT, GEN = 2, 8, 6
LOGIT_TOL = 1e-4
TIE_MARGIN = 1e-3


def _arch(name):
    arch = jconfigs.get_config(name)
    return dataclasses.replace(arch, model=arch.model.reduce())


def _reference_logits(arch, tree, teacher):
    """JAX's serve path (prefill, caches re-homed to prompt+gen, decode
    steps), teacher-forced with ``teacher``: the prefill's last logits and
    each decode step's."""
    cfg = arch.model
    rng = np.random.default_rng(0)  # the prompt serve draws for seed 0
    shape = (B, PROMPT, cfg.num_codebooks) if cfg.family == "audio" else (B, PROMPT)
    prompt = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    logits, cp = jax.jit(lambda p, b: jt.prefill(p, b, cfg))(tree, {"tokens": jnp.asarray(prompt)})
    if cfg.family == "ssm":
        caches = cp  # the reference serve's branches (src/repro/launch/serve.py)
    else:
        caches = jt.init_caches(cfg, B, PROMPT + GEN)
        for k in ("k", "v"):
            caches[k] = jax.lax.dynamic_update_slice_in_dim(caches[k], cp[k], 0, axis=2)
        for k in ("conv", "ssm"):
            if k in caches:
                caches[k] = cp[k]
    step = jax.jit(lambda p, b, c, n: jt.decode_step(p, b, c, n, cfg))
    out = [logits]
    for i in range(GEN - 1):
        logits, caches = step(tree, {"tokens": jnp.asarray(teacher[:, i])}, caches,
                              jnp.int32(PROMPT + i))
        out.append(logits)
    return [np.asarray(x, np.float32) for x in out]


@pytest.mark.parametrize("name", ["qwen2-7b", "musicgen-medium", "rwkv6-3b", "hymba-1.5b",
                                  "mixtral-8x22b"])
def test_serve_matches_jax(name):
    arch = _arch(name)
    cfg = arch.model
    jtoks = jserve.serve(name, batch=B, prompt_len=PROMPT, gen=GEN, seed=0)
    tree = jt.init_params(jax.random.key(0), cfg)  # the weights JAX's serve drew
    model = params_from_jax(tree, cfg, "cpu")
    record = {}
    toks = serve(name, batch=B, prompt_len=PROMPT, gen=GEN, seed=0, device="cpu",
                 params=model, teacher=jtoks, record=record, keep_logits=True)
    assert toks.shape == jtoks.shape and toks.dtype == np.int32
    want = _reference_logits(arch, tree, jtoks)
    assert len(record["logits"]) == GEN
    for i, (got, ref) in enumerate(zip(record["logits"], want)):
        np.testing.assert_allclose(got.float().numpy(), ref, atol=LOGIT_TOL,
                                   err_msg=f"logits of step {i}")
    top2 = np.sort(np.stack(want, axis=1), axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > TIE_MARGIN
    np.testing.assert_array_equal(toks[clear], jtoks[clear])
    assert clear.mean() > 0.5
    assert record["prefill_ms"] > 0 and record["decode_ms_per_token"] > 0


def test_step_builders_match_jax():
    arch = _arch("starcoder2-3b")
    cfg = arch.model
    tree = jt.init_params(jax.random.key(1), cfg)
    model = params_from_jax(tree, cfg, "cpu")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    jtok, jc = jbuild_prefill_step(arch)(tree, {"tokens": jnp.asarray(prompt)})
    ttok, tc = tstep.build_prefill_step(arch)(model, {"tokens": torch.from_numpy(prompt)})
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), atol=LOGIT_TOL)
    jcaches = jt.init_caches(cfg, B, PROMPT + 1)
    tcaches = {k: torch.zeros(v.shape) for k, v in jcaches.items()}
    for k in ("k", "v"):
        jcaches[k] = jcaches[k].at[:, :, :PROMPT].set(jc[k])
        tcaches[k][:, :, :PROMPT] = tc[k]
    jnext, jcaches = jbuild_serve_step(arch)(tree, {"tokens": jtok.astype(jnp.int32)},
                                             jcaches, jnp.int32(PROMPT))
    tnext, out = tstep.build_serve_step(arch)(model, {"tokens": ttok}, tcaches, PROMPT)
    assert out is tcaches
    np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))
    np.testing.assert_allclose(tcaches["v"].numpy(), np.asarray(jcaches["v"]), atol=LOGIT_TOL)


def test_serve_takes_prompts_from_the_pipeline():
    """The prompts of a prefetched synthetic batch (the vlm family's
    embeddings and M-RoPE positions) go through serve."""
    cfg = get_config("qwen2-vl-2b").model.reduce()
    pre = prefetched(cfg, ShapeConfig("serve", PROMPT, B, "prefill"), device="cpu")
    record = {}
    toks = serve("qwen2-vl-2b", batch=B, prompt_len=PROMPT, gen=3, device="cpu",
                 prompts=pre, record=record, keep_logits=True)
    assert toks.shape == (B, 3)
    assert all(bool(torch.isfinite(x).all()) for x in record["logits"])
    with pytest.raises(ValueError, match="want"):
        serve("qwen2-vl-2b", batch=B + 1, prompt_len=PROMPT, gen=2, device="cpu",
              prompts=prefetched(cfg, ShapeConfig("s", PROMPT, B, "prefill"), device="cpu"))


def test_serve_main_on_the_cpu(capsys):
    main(["--arch", "starcoder2-3b", "--batch", "2", "--prompt-len", "4", "--gen", "3",
          "--device", "cpu"])
    assert "[starcoder2-3b] generated (2, 3) tokens" in capsys.readouterr().out


def test_serve_refuses_params_on_another_device():
    cfg = get_config("qwen2-7b").model.reduce()
    model = params_from_jax(jt.init_params(jax.random.key(0), cfg), cfg, "meta")
    with pytest.raises(ValueError, match="params are on meta"):
        serve("qwen2-7b", device="cpu", params=model)
