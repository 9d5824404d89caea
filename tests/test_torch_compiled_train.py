"""The port's train step as the reference compiles it: ``build_train_step``
with no mesh gives a ``GraphTrainStep`` (the whole step, optimizer
included, one CUDA graph on a card, the state updated in place as the
reference's ``jax.jit(..., donate_argnums=(0, 1))`` donates it).  On the
CPU the step runs its body eagerly on the same static buffers, so these
tests exercise everything but the capture, which ``chip_smoke.py`` holds on
the card: with the step a 0-d int32 tensor it matches JAX's jitted step;
a tensor step gives the int step's bits; the step reads nothing on the host
and builds no tensor from host data in any reduced config; the routes; the
binding to params, state and batch; ``train`` through ``build_train_step``;
the host plan's offload back into the tensors it fetched from; and
chip_smoke's unfilled-step fault.

Tolerance: against JAX, ``STEP_TOL`` (1e-5) of tests/test_torch_train.py's
``test_train_step_matches_jax``, whose inputs and check these share; every
other comparison exactly."""
import dataclasses
import importlib.util
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from _torch_host_reads import NoHostRead  # noqa: E402
from _torch_train_case import STEP_CASES, archs, check_train_step, plans  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint.checkpointer import tree_leaves  # noqa: E402
from repro_torch.configs import ARCH_NAMES  # noqa: E402
from repro_torch.core import streaming  # noqa: E402
from repro_torch.core import residency as tres  # noqa: E402
from repro_torch.core.advise import MemorySpace  # noqa: E402
from repro_torch.data import DataConfig, synthetic_batches  # noqa: E402
from repro_torch.launch import step as tstep  # noqa: E402
from repro_torch.launch import train as ttrain_mod  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

B, S = 2, 16


class _NoHostData(NoHostRead):
    where = "the train step"
    host_data = True


def _step_case(case: str, name: str = "starcoder2-3b"):
    """(arch, plan) of the port for a case of ``STEP_CASES`` or
    "host_int8_offload" (the planner's last escalation: int8 moments on the
    host and remat "offload"), reduced, with a warmup of 2 so that the lr
    moves from step to step."""
    _, arch = archs(name, warmup_steps=2, learning_rate=3e-3,
                    microbatches=2 if case == "micro2" else 1)
    plan = None
    if case.startswith("host_int8"):
        remat = "offload" if case == "host_int8_offload" else arch.train.remat
        plan = plans(*archs(name), opt_space=MemorySpace.HOST, int8_moments=True,
                     remat=remat)[1]
    return arch, plan


def _fresh(arch, plan, seed=0):
    """Seeded params and a fresh state, and the step built for them."""
    model = tt.init_params(arch.model, torch.Generator().manual_seed(seed), "cpu")
    state = tadamw.init_state(model, tstep._adamw_cfg(arch, plan))
    step = tstep.build_train_step(arch, tconfigs.ShapeConfig("t", S, B, "train"), None, plan,
                                  total_steps=10, device="cpu")
    return model, state, step


def _batches(cfg, n=2, seed=1) -> list[dict]:
    gen = synthetic_batches(cfg, tconfigs.ShapeConfig("t", S, B, "train"), DataConfig(seed=seed))
    return [{k: torch.from_numpy(v) for k, v in next(gen).items()} for _ in range(n)]


def _leaves(model, state) -> list:
    return [x.detach().clone() for x in tree_leaves((model, state))]


@pytest.mark.parametrize("case", STEP_CASES)
def test_tensor_step_matches_jax(case):
    """The step as a 0-d int32 tensor, as the graph reads it: loss, grad
    norm, lr, parameters and state against JAX's jitted step."""
    check_train_step(case, tensor_step=True)


@pytest.mark.parametrize("case", STEP_CASES)
def test_tensor_step_is_the_int_step_bit_for_bit(case):
    """Two steps (lr 1.5e-3, then 3e-3) given as ints and as tensors: the
    same metrics and the same parameters and state, bit for bit; the step
    returns the objects it was given."""
    arch, plan = _step_case(case)
    batches = _batches(arch.model)
    runs = []
    for as_tensor in (False, True):
        model, state, step = _fresh(arch, plan)
        metrics = []
        for i, b in enumerate(batches, start=1):
            p, s, m = step(model, state, b, torch.tensor(i, dtype=torch.int32) if as_tensor else i)
            assert p is model and s is state
            metrics.append(m)
        runs.append((metrics, _leaves(model, state)))
    (m_int, l_int), (m_t, l_t) = runs
    assert [float(m["lr"]) for m in m_int] == pytest.approx([1.5e-3, 3e-3])
    for a, b in zip(m_int, m_t):
        assert all(torch.equal(a[k], b[k]) for k in ("loss", "grad_norm", "lr"))
    assert all(torch.equal(x, y) for x, y in zip(l_int, l_t))


@pytest.mark.parametrize("name,case", [(n, "fp32") for n in ARCH_NAMES]
                         + [("starcoder2-3b", "micro2"), ("starcoder2-3b", "host_int8"),
                            ("starcoder2-3b", "host_int8_offload")])
def test_the_step_reads_nothing_on_the_host(name, case):
    """Every reduced config (mixtral-8x22b, qwen2-72b and grok-1-314b with
    their 8 microbatches, here min(8, B) = 2), 2 microbatches, int8 moments
    on the host plan, and that plan under remat "offload": the whole step,
    with a tensor step, makes no host read, no data-dependent shape and no
    tensor from host data, any of which a capture refuses or freezes."""
    arch, plan = _step_case(case, name)
    model, state, step = _fresh(arch, plan)
    (batch,) = _batches(arch.model, 1)
    n = torch.tensor(3, dtype=torch.int32)
    with _NoHostData():
        _, _, m = step(model, state, batch, n)
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert int(state["step"]) == 1


class _OldClip(types.ModuleType):
    """``torch`` as ``optim/adamw.py`` sees it, but for ``torch.full``,
    which builds its value with ``torch.tensor`` as ``clip_by_global_norm``
    built its limit before the step was captured."""

    def __init__(self):
        super().__init__("torch")

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def full(size, value, dtype=None, device=None):
        return torch.tensor(value, dtype=dtype, device=device)


def test_the_mode_catches_tensors_built_from_host_data(monkeypatch):
    """The mode raises on ``clip_by_global_norm``'s limit built by
    ``torch.tensor`` (a pageable host copy on a card) and on the body's lr
    from an int step (frozen into the kernels by a capture), and not on the
    step as it is."""
    arch, plan = _step_case("fp32")
    model, state, step = _fresh(arch, plan)
    (batch,) = _batches(arch.model, 1)
    norm = torch.ones(())
    with _NoHostData(), pytest.raises(RuntimeError, match="lift_fresh.*inside the train step"):
        torch.tensor(1.0, dtype=torch.float32, device=norm.device)
    with _NoHostData(), pytest.raises(RuntimeError, match="lift_fresh"):
        step.body(model, state, batch, 3)
    n = torch.tensor(3, dtype=torch.int32)
    monkeypatch.setattr(tadamw, "torch", _OldClip())
    with _NoHostData(), pytest.raises(RuntimeError, match="lift_fresh"):
        step(model, state, batch, n)
    monkeypatch.undo()
    model, state, step = _fresh(arch, plan)
    with _NoHostData():
        step(model, state, batch, n)


class _Mesh:
    """What ``build_train_step`` reads of a (1, 1) mesh to build its step."""
    device_type = "cpu"
    mesh_dim_names = ("data", "model")
    shape = (1, 1)


def test_build_train_step_routes():
    """A graph step with no mesh under every remat (its body the eager
    step), the eager step on a mesh; the "offload" plan's graph step gives
    the "full" plan's bits ("offload" recomputes as "full" does)."""
    arch, _ = _step_case("fp32")
    shape = tconfigs.ShapeConfig("t", S, B, "train")
    step = tstep.build_train_step(arch, shape, device="cpu")
    assert isinstance(step, tstep.GraphTrainStep) and callable(step.body)
    assert step.graph is None and step.capture_ms == 0.0
    assert not isinstance(tstep.build_train_step(arch, shape, _Mesh()), tstep.GraphTrainStep)
    batches = _batches(arch.model)
    runs = []
    for remat in ("full", "offload"):
        plan = plans(*archs("starcoder2-3b"), remat=remat)[1]
        model, state, _ = _fresh(arch, plan)
        step = tstep.build_train_step(arch, shape, None, plan, total_steps=10, device="cpu")
        assert isinstance(step, tstep.GraphTrainStep)
        for i, b in enumerate(batches, start=1):
            step(model, state, b, i)
        runs.append(_leaves(model, state))
    assert all(torch.equal(x, y) for x, y in zip(*runs))


def test_the_planners_last_escalation_trains_through_the_graph_step():
    """A budget that nothing fits takes the planner to its last step (int8
    moments, the state on the host, remat "offload"); ``build_train_step``
    gives that plan a ``GraphTrainStep``, whose steps equal, bit for bit,
    those of the same plan under remat "full"."""
    arch, _ = _step_case("fp32")
    shape = tconfigs.ShapeConfig("t", S, B, "train")
    plan = tres.ResidencyPlanner(1e3).plan(arch, shape, tconfigs.MeshConfig(False))
    assert (plan.int8_moments, plan.opt_space, plan.remat) == (True, MemorySpace.HOST,
                                                              "offload")
    assert not plan.fits
    batches = _batches(arch.model)
    runs = []
    for p in (plan, dataclasses.replace(plan, remat="full")):
        model, state, _ = _fresh(arch, p)
        step = tstep.build_train_step(arch, shape, None, p, total_steps=10, device="cpu")
        assert isinstance(step, tstep.GraphTrainStep) and step.opt_on_host
        for i, b in enumerate(batches, start=1):
            step(model, state, b, i)
        runs.append(_leaves(model, state))
    assert all(torch.equal(x, y) for x, y in zip(*runs))


def test_the_step_is_bound_to_its_params_state_and_batch():
    """From its first call the step refuses other params, another state, a
    state whose tensors were replaced, a batch of another shape or dtype,
    and params on another device; after each refusal it goes on as if none
    had been made."""
    arch, plan = _step_case("fp32")
    b1, b2 = _batches(arch.model)
    model, state, step = _fresh(arch, plan)
    want_model, want_state, want_step = _fresh(arch, plan)
    step(model, state, b1, 1)
    want_step(want_model, want_state, b1, 1)
    other, other_state, _ = _fresh(arch, plan, seed=1)
    for p, s in ((other, state), (model, other_state), (model, dict(state))):
        with pytest.raises(ValueError, match="bound to other params or optimizer state"):
            step(p, s, b2, 2)
    name = next(iter(state["leaves"]))
    kept = state["leaves"][name]["m"]
    state["leaves"][name]["m"] = kept.clone()
    with pytest.raises(ValueError, match="bound to other params"):
        step(model, state, b2, 2)
    state["leaves"][name]["m"] = kept
    for bad in ({k: v[:, :-1] for k, v in b2.items()}, {k: v.long() for k, v in b2.items()},
                {"tokens": b2["tokens"]}):
        with pytest.raises(ValueError, match="bound to a batch"):
            step(model, state, bad, 2)
    step(model, state, b2, 2)
    want_step(want_model, want_state, b2, 2)
    assert all(torch.equal(x, y) for x, y in zip(_leaves(model, state),
                                                 _leaves(want_model, want_state)))
    meta = tstep.build_train_step(arch, tconfigs.ShapeConfig("t", S, B, "train"), device="meta")
    with pytest.raises(ValueError, match="the step on meta"):
        meta(model, state, b1, 1)


def test_train_trains_through_build_train_step(tmp_path, monkeypatch):
    """train builds its step with ``build_train_step`` (no mesh, no plan),
    gets a ``GraphTrainStep`` and calls it every step with the int step on
    the run's params and state; the losses are those of the run that
    ``build_train_step``'s own step gives, and a fault at step 3 replays the
    same step on the restored state."""
    kw = dict(steps=5, batch=B, seq=S, checkpoint_every=2, device="cpu")
    _, want = ttrain_mod.train("qwen2-7b", ckpt_dir=str(tmp_path / "a"), **kw)
    real, calls, built = tstep.build_train_step, [], []

    def recording(arch, shape, mesh=None, plan=None, *, total_steps=10_000, device=None):
        step = real(arch, shape, mesh, plan, total_steps=total_steps, device=device)
        assert isinstance(step, tstep.GraphTrainStep)
        calls.append(("build", arch.model.name, (shape.global_batch, shape.seq_len), mesh,
                      plan, total_steps, device))
        built.append(step)

        def counted(params, opt_state, batch, i):
            calls.append(("step", i))
            return step(params, opt_state, batch, i)

        return counted

    monkeypatch.setattr(ttrain_mod, "build_train_step", recording)
    _, got = ttrain_mod.train("qwen2-7b", ckpt_dir=str(tmp_path / "b"), **kw)
    assert got.losses == want.losses
    assert calls == [("build", "qwen2-7b", (B, S), None, None, 5, torch.device("cpu"))] + [
        ("step", i) for i in range(5)]
    calls.clear()
    _, faulted = ttrain_mod.train("qwen2-7b", ckpt_dir=str(tmp_path / "c"),
                                  fault_schedule=(3,), **kw)
    assert faulted.restarts == 1 and faulted.losses[-2:] == want.losses[-2:]
    assert [c for c in calls if c[0] == "step"] == [("step", i) for i in (0, 1, 2, 2, 3, 4)]


def test_the_host_plans_offload_writes_back_into_the_tensors_it_fetched(monkeypatch):
    """With the fetch making new tensors, as the card's does, the host
    plan's step writes the update back into the state's own tensors (the
    same objects and ``data_ptr``s) and gives the device plan's bits; on the
    CPU, where the fetch is the identity, the offload writes nothing."""
    arch, plan = _step_case("host_int8")
    dev_plan = dataclasses.replace(plan, opt_space=MemorySpace.DEVICE)
    batches = _batches(arch.model)
    model, state, step = _fresh(arch, plan)
    leaves = tree_leaves(state)
    ptrs = [x.data_ptr() for x in leaves]
    fetched = []

    def fetch(tree, device=None):
        fetched.append(streaming._map_tensors(lambda x: x.clone(), tree))
        return fetched[-1]

    monkeypatch.setattr(tstep, "fetch_params", fetch)
    for i, b in enumerate(batches, start=1):
        _, s, _ = step(model, state, b, i)
        assert s is state
    assert len(fetched) == 2 and int(state["step"]) == 2
    assert [x.data_ptr() for x in tree_leaves(state)] == ptrs
    assert all(x is y for x, y in zip(tree_leaves(state), leaves))
    want_model, want_state, want_step = _fresh(arch, dev_plan)
    for i, b in enumerate(batches, start=1):
        want_step(want_model, want_state, b, i)
    assert all(torch.equal(x, y) for x, y in zip(_leaves(model, state),
                                                 _leaves(want_model, want_state)))


def test_offload_into_copies_into_the_destination_tree():
    """``offload_into`` writes each source tensor into its destination
    (dicts and lists), skips a tensor that is its own source, and returns the
    destination."""
    dst = {"a": torch.zeros(3), "b": [torch.zeros(2, dtype=torch.int8)], "c": torch.ones(())}
    src = {"a": torch.arange(3.0), "b": [torch.full((2,), 7, dtype=torch.int8)], "c": dst["c"]}
    keep = [x.data_ptr() for x in (dst["a"], dst["b"][0], dst["c"])]
    out = streaming.offload_into(dst, src)
    assert out is dst
    assert [x.data_ptr() for x in (dst["a"], dst["b"][0], dst["c"])] == keep
    assert torch.equal(dst["a"], torch.arange(3.0)) and dst["b"][0].tolist() == [7, 7]
    assert float(dst["c"]) == 1.0


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_catches_the_step_left_unfilled():
    """``chip_smoke.step_not_filled``: steps 2 and 3 run at step 1's lr,
    which leaves the parameters different from those of steps 1-3; the step
    fills its buffer again after it."""
    cs = _chip_smoke()
    arch, plan = _step_case("fp32")
    batches = _batches(arch.model, 3)
    runs = []
    for fault in (False, True):
        model, state, step = _fresh(arch, plan)
        step(model, state, batches[0], 1)
        with cs.step_not_filled(step) if fault else cs.contextlib.nullcontext():
            for i, b in enumerate(batches[1:], start=2):
                _, _, m = step(model, state, b, i)
        runs.append((float(m["lr"]), _leaves(model, state)))
        step(model, state, batches[0], 4)
        assert int(step._step) == 4
    (lr, clean), (lr_fault, faulty) = runs
    assert lr_fault == pytest.approx(1.5e-3) and lr != lr_fault
    assert not all(torch.equal(x, y) for x, y in zip(clean, faulty))
