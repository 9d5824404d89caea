"""The port's movement layer on the CPU against the JAX package: the
pipeline (``repro_torch.data``) bit for bit, the prefetch iterator's pull
order, ``transform`` and exhaustion, and the placement and streaming
identities where there is no host tier."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.core import advise as jadvise  # noqa: E402
from repro.core.prefetch import PrefetchIterator as JPrefetchIterator  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import synthetic_batches as jsynthetic_batches  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import advise, placement, streaming  # noqa: E402
from repro_torch.core.prefetch import PrefetchIterator, prefetch_to_device  # noqa: E402
from repro_torch.data import DataConfig, prefetched, synthetic_batches  # noqa: E402


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# The reference's four pipeline tests (tests/test_attention_and_data.py), on
# the port
# ---------------------------------------------------------------------------

def test_pipeline_deterministic():
    cfg = get_config("qwen2-7b").model.reduce()
    shape = ShapeConfig("t", 16, 4, "train")
    a = list(zip(range(3), synthetic_batches(cfg, shape, DataConfig(seed=7))))
    b = list(zip(range(3), synthetic_batches(cfg, shape, DataConfig(seed=7))))
    for (_, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(x["tokens"], y["tokens"])


def test_pipeline_labels_are_shifted_tokens():
    cfg = get_config("qwen2-7b").model.reduce()
    shape = ShapeConfig("t", 16, 2, "train")
    batch = next(synthetic_batches(cfg, shape))
    np.testing.assert_array_equal(batch["labels"][:, :-1], batch["tokens"][:, 1:])


def test_prefetch_iterator_equivalence():
    cfg = get_config("qwen2-7b").model.reduce()
    shape = ShapeConfig("t", 16, 2, "train")
    plain = [next(synthetic_batches(cfg, shape)) for _ in range(1)]
    pre = prefetched(cfg, shape, device="cpu", depth=3)
    first = next(pre)
    np.testing.assert_array_equal(_np(first["tokens"]), plain[0]["tokens"])


def test_vlm_batch_has_frontend_stub():
    cfg = get_config("qwen2-vl-2b").model.reduce()
    shape = ShapeConfig("t", 8, 2, "train")
    batch = next(synthetic_batches(cfg, shape))
    assert batch["embeds"].shape == (2, 8, cfg.d_model)
    assert batch["positions_thw"].shape == (2, 8, 3)


# ---------------------------------------------------------------------------
# Bit for bit against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2-vl-2b", "musicgen-medium"])
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full-width"])
def test_synthetic_batches_bit_identical_to_jax(arch, reduced):
    cfg, jcfg = get_config(arch).model, jget_config(arch).model
    if reduced:
        cfg, jcfg = cfg.reduce(), jcfg.reduce()
    S, B = (16, 3) if reduced else (8, 2)
    data, jdata = DataConfig(seed=11, process_index=1), JDataConfig(seed=11, process_index=1)
    mine = synthetic_batches(cfg, ShapeConfig("t", S, B, "train"), data)
    ref = jsynthetic_batches(jcfg, JShapeConfig("t", S, B, "train"), jdata)
    for a, b in itertools.islice(zip(mine, ref), 3):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


class _Counting:
    """An iterator that logs each pull, so two prefetchers' pull orders can
    be compared with the hand-overs between them."""

    def __init__(self, n, log):
        self.n, self.i, self.log = n, 0, log

    def __iter__(self):
        return self

    def __next__(self):
        if self.i == self.n:
            self.log.append("end")
            raise StopIteration
        self.i += 1
        self.log.append(f"pull {self.i - 1}")
        return {"x": np.full((2,), self.i - 1, np.int32)}


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_pull_order_matches_jax(depth):
    logs = {}
    for name, make in (("jax", lambda it: JPrefetchIterator(it, depth=depth)),
                       ("port", lambda it: PrefetchIterator(it, "cpu", depth=depth))):
        log = logs[name] = []
        pre = make(_Counting(5, log))
        for batch in pre:
            log.append(f"got {int(_np(batch['x'])[0])}")
    assert logs["port"] == logs["jax"]
    assert logs["port"][-1] == "got 4" and logs["port"].count("end") == 1


def test_transform_and_exhaustion():
    seen = []
    pre = PrefetchIterator(iter([{"a": np.arange(3)}, {"a": np.arange(3) + 10}]), "cpu",
                           depth=2, transform=lambda b: seen.append(1) or {"a": b["a"] * 2})
    first = next(pre)
    assert isinstance(first["a"], torch.Tensor)
    np.testing.assert_array_equal(first["a"].numpy(), [0, 2, 4])
    np.testing.assert_array_equal(next(pre)["a"].numpy(), [20, 22, 24])
    assert len(seen) == 2
    with pytest.raises(StopIteration):
        next(pre)
    with pytest.raises(StopIteration):
        next(pre)
    assert list(PrefetchIterator(iter([]), "cpu")) == []


def test_prefetch_keeps_non_array_leaves():
    out = prefetch_to_device({"a": np.ones(2), "b": [3, None]}, "cpu")
    assert isinstance(out["a"], torch.Tensor) and out["b"] == [3, None]


# ---------------------------------------------------------------------------
# Placement, streaming and advise on the CPU
# ---------------------------------------------------------------------------

def test_no_host_tier_on_the_cpu():
    assert placement.backend_supports_memory_kinds("cpu") is False
    x = torch.ones(3)
    assert placement.to_device_space(x, "cpu") is x
    assert placement.to_host_space(x, "cpu") is x
    assert placement.host().space is advise.MemorySpace.HOST
    assert placement.device(("data",)).spec == ("data",)
    tree = {"w": x, "b": [x, 2]}
    assert streaming.fetch_params(tree, "cpu") is tree
    assert streaming.offload_params(tree, "cpu") is tree


def test_advise_copy_matches_jax():
    spec = {"opt_state": ["preferred_location:host", "accessed_by:device"],
            "embedding": ["read_mostly"]}
    mine, ref = advise.AdvisePolicy.from_spec(spec), jadvise.AdvisePolicy.from_spec(spec)
    for role in ("opt_state", "embedding", "params"):
        assert mine.is_read_mostly(role) == ref.is_read_mostly(role)
        assert str(mine.preferred_location(role)) == str(ref.preferred_location(role))
        assert [a.value for a in mine.accessed_by(role)] == [
            a.value for a in ref.accessed_by(role)]
    assert {m.value for m in advise.MemorySpace} == {m.value for m in jadvise.MemorySpace}
    assert (advise.paper_default_policy().preferred_location("kv_cache").value
            == jadvise.paper_default_policy().preferred_location("kv_cache").value)
    with pytest.raises(ValueError):
        advise.AdviseDirective(advise.Advise.READ_MOSTLY, location=advise.MemorySpace.HOST)
