"""The port's sharding rules (``repro_torch.launch.sharding``) against the
JAX package's, and ``shard_hint``'s placement choice.

Specs are compared exactly: JAX's ``PartitionSpec`` as a tuple, with the
leading ``None`` of a stacked layer leaf dropped (a block's tensor has no
L dim).  The JAX meshes are ``AbstractMesh``es (no devices); the port's
``launch.mesh.AbstractMesh`` stands for the same axes.  ``shard_hint`` is
checked on a fake-backend mesh in a subprocess, so that the pytest process
never holds a process group."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import sharding as tsh  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh as TMesh  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
MODES = ("2d", "fsdp", "zero1")
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture
def mode():
    """Set both frameworks' sharding mode, and put it back."""
    def set_(m):
        jcommon.set_sharding_mode(m)
        tcommon.set_sharding_mode(m)
    yield set_
    set_("2d")


def _jax_flat(tree, l_data: bool = False) -> dict:
    """JAX's spec tree as {port name: tuple}: ``layers/a/b`` stacked leaves
    become one entry per block name pattern ``a.b`` with L dropped.  With
    ``l_data`` (zero1's optimizer state) the dropped L dim may be "data":
    ROADMAP.md section 3, the state of such a leaf keeps its param spec."""
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for path, spec in flat:
        name = jsh._path_str(path)
        spec = tuple(spec)
        if name.startswith("layers/"):
            assert spec[:1] in ((), (None,)) + ((("data",),) if l_data else ()), (name, spec)
            out[name[len("layers/"):].replace("/", ".")] = spec[1:]
        else:
            out[name.replace("/", ".")] = spec
    return out


def _port_flat(specs: dict) -> dict:
    """The port's {blocks.<i>.a.b: spec} as {a.b: spec}, every block equal."""
    out = {}
    for name, spec in specs.items():
        if name.startswith("blocks."):
            key = name.split(".", 2)[2]
            assert out.setdefault(key, spec) == spec, name
        else:
            out[name] = spec
    return out


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
@pytest.mark.parametrize("m", MODES)
def test_param_and_opt_specs_match_jax(arch, m, mode):
    mode(m)
    jarch, tarch = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jparams = jt.abstract_params(jarch.model)
    model = Transformer(tarch.model, device="meta")
    for jfn, tfn in ((jsh.param_specs, tsh.param_specs), (jsh.opt_specs, tsh.opt_specs)):
        want = _jax_flat(jfn(jarch.model, jparams, m), l_data=jfn is jsh.opt_specs)
        got = _port_flat(tfn(tarch.model, model, m))
        assert got == want, (jfn.__name__, {k: (got.get(k), want.get(k))
                                            for k in set(got) | set(want)
                                            if got.get(k) != want.get(k)})


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("m", ("2d", "fsdp"))
def test_batch_and_cache_specs_match_jax(arch, mesh, m, mode):
    mode(m)
    sizes, names = MESHES[mesh]
    jmesh, tmesh = AbstractMesh(sizes, names), TMesh(sizes, names)
    jcfg, tcfg = jconfigs.get_config(arch).model, tconfigs.get_config(arch).model
    for kind in ("train", "prefill", "decode"):
        for gb in (None, 1, 4, 32, 256):
            want = {k: tuple(v) for k, v in jsh.batch_specs(jcfg, jmesh, kind, gb).items()}
            assert tsh.batch_specs(tcfg, tmesh, kind, gb) == want, (kind, gb)
    for batch in (1, 4, 32, 128):
        want = {k: tuple(v) for k, v in jsh.cache_specs(jcfg, jmesh, batch).items()}
        assert tsh.cache_specs(tcfg, tmesh, batch) == want, batch


HINT_SCRIPT = r"""
import json
import torch
from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor, DTensor
from repro_torch.launch.mesh import fake_process_group, make_test_mesh, mesh_context
from repro_torch.models import common as c

fake_process_group(8)
mesh = make_test_mesh((2, 4), device_type="cpu")
x = torch.zeros(8, 8, 16)
out = {}
cases = {
    "batch_seq": ((c.BATCH, c.SEQ, c.UNC), [Replicate(), Replicate()]),
    "keep_unc": ((c.BATCH, c.UNC, c.UNC), [Replicate(), Shard(2)]),
    "drop_none": ((c.BATCH, None, c.UNC), [Replicate(), Shard(1)]),
    "partial": ((c.BATCH, c.UNC, c.UNC), [Partial(), Partial()]),
    "model_only": ((None, "model"), [Shard(0), Shard(0)]),
    "no_axis": ((None, c.UNC, c.UNC), [Shard(0), Shard(1)]),
    "short_spec": ((c.BATCH,), [Replicate(), Shard(2)]),
}
with mesh_context(mesh):
    for mode in ("2d", "fsdp"):
        c.set_sharding_mode(mode)
        for name, (spec, cur) in cases.items():
            d = DTensor.from_local(torch.zeros(8, 8, 16), mesh, cur, run_check=False)
            got = c.shard_hint(d, spec)
            out[f"{mode}/{name}"] = [repr(p) for p in got.placements]
    c.set_sharding_mode("2d")
    out["plain"] = c.shard_hint(x, (c.BATCH,)) is x
    odd = DTensor.from_local(torch.zeros(3, 8), mesh, [Replicate(), Shard(1)], run_check=False)
    out["uneven"] = [repr(p) for p in c.shard_hint(odd, (c.BATCH, c.UNC)).placements]
out["no_mesh"] = c.shard_hint(DTensor.from_local(x, mesh, [Replicate(), Replicate()]),
                              (c.BATCH,)).placements == (Replicate(), Replicate())
from repro_torch.core.streaming import _map_tensors
d = DTensor.from_local(torch.ones(8, 4), mesh, [Shard(0), Replicate()], run_check=False)
moved = _map_tensors(lambda t: t * 2, {"m": d})["m"]
out["moved"] = [type(moved).__name__, [repr(p) for p in moved.placements], list(moved.shape),
                moved.to_local().sum().item()]
print(json.dumps(out))
"""


def _run(script: str, timeout: float = 120) -> dict:
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=timeout, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_shard_hint_placements():
    """BATCH is data (2d) or data and model (fsdp); SEQ is model under 2d
    and unsharded under fsdp; an UNC dim keeps its shard, a None dim and a Partial replicate, a dim its
    axes do not divide replicates; a spec naming no axis leaves the tensor
    alone."""
    got = _run(HINT_SCRIPT)
    S, R = "Shard(dim={})".format, "Replicate()"
    assert got["2d/batch_seq"] == [S(0), S(1)]
    assert got["fsdp/batch_seq"] == [S(0), S(0)]
    assert got["2d/keep_unc"] == [S(0), S(2)]
    assert got["2d/drop_none"] == [S(0), R]
    assert got["2d/partial"] == [S(0), R]
    assert got["fsdp/partial"] == [S(0), S(0)]
    assert got["2d/model_only"] == [R, S(1)]
    assert got["2d/no_axis"] == [S(0), S(1)]
    assert got["fsdp/no_axis"] == [S(0), S(1)]
    assert got["2d/short_spec"] == [S(0), R]
    assert got["uneven"] == [R, S(1)]  # 3 rows over data 2: whole
    assert got["plain"] and got["no_mesh"]


def test_host_moves_act_on_the_local_shard():
    """The host plan's fetch / offload map (``core/streaming._map_tensors``)
    moves a DTensor's local shard and keeps its mesh, placements and global
    shape."""
    got = _run(HINT_SCRIPT)
    assert got["moved"] == ["DTensor", ["Shard(dim=0)", "Replicate()"], [16, 4], 64.0]


def test_spec_placements_follow_the_mesh_order():
    """A dim over (data, model) is Shard on both mesh dims, Replicate over
    an axis of size 1; an entry that names the axes against the mesh's
    order raises."""
    mesh = type("M", (), {"mesh_dim_names": ("data", "model"), "shape": (2, 4)})()
    one = type("M", (), {"mesh_dim_names": ("data", "model"), "shape": (1, 4)})()
    from torch.distributed.tensor import Replicate, Shard
    assert tcommon.spec_placements((None, ("data", "model")), mesh) == [Shard(1), Shard(1)]
    assert tcommon.spec_placements((None, ("data", "model")), one) == [Replicate(), Shard(1)]
    assert tcommon.spec_placements(("model",), mesh) == [Replicate(), Shard(0)]
    assert tcommon.spec_placements((), mesh) == [Replicate(), Replicate()]
    with pytest.raises(ValueError):
        tcommon.spec_placements((("model", "data"),), mesh)


def test_fake_backend_is_present():
    """The dry-run's fake process group (an internal module of torch) is
    importable and carries a (16, 16) CPU mesh."""
    got = _run(
        "import json\n"
        "from repro_torch.launch.mesh import fake_process_group, make_production_mesh\n"
        "fake_process_group(256)\n"
        "m = make_production_mesh(device_type='cpu')\n"
        "print(json.dumps([list(m.shape), list(m.mesh_dim_names)]))\n")
    assert got == [[16, 16], ["data", "model"]]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_config_and_batch_axes_match_jax(mesh):
    from repro.launch import mesh as jmesh_mod
    from repro_torch.launch import mesh as tmesh_mod
    sizes, names = MESHES[mesh]
    jm, tm = AbstractMesh(sizes, names), TMesh(sizes, names)
    assert tmesh_mod.mesh_config_of(tm).multi_pod == jmesh_mod.mesh_config_of(jm).multi_pod
    assert tmesh_mod.batch_axes(tm) == jmesh_mod.batch_axes(jm)


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_abstract_inputs_match_jax(arch):
    """input_specs, abstract_params, abstract_opt_state and abstract_caches
    (meta tensors) against JAX's ShapeDtypeStructs: every leaf's shape and
    dtype, blocks against the stacked leaves' rows."""
    from repro.launch import step as jstep
    from repro_torch.launch import step as tstep
    ja, ta = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        js, ts = jconfigs.get_shape(shape), tconfigs.get_shape(shape)
        want = jstep.input_specs(ja, js)
        got = tstep.input_specs(ta, ts)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} == {
            k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in got.items()}
        assert all(v.device.type == "meta" for v in got.values())
        if js.kind == "decode" and ja.supports_shape(js)[0]:
            jc, tc = jstep.abstract_caches(ja, js), tstep.abstract_caches(ta, ts)
            assert {k: tuple(v.shape) for k, v in jc.items()} == {
                k: tuple(v.shape) for k, v in tc.items()}
    jp = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jt.abstract_params(ja.model))[0]:
        name = jsh._path_str(path)
        stacked = name.startswith("layers/")
        key = name[len("layers/"):] if stacked else name
        jp[key.replace("/", ".")] = (tuple(leaf.shape[1:] if stacked else leaf.shape),
                                     str(leaf.dtype))
    tp = _port_flat({n: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
                     for n, p in tstep.abstract_params(ta).named_parameters()})
    assert tp == jp
    state = tstep.abstract_opt_state(ta)
    assert state["leaves"].keys() == dict(tstep.abstract_params(ta).named_parameters()).keys()


def test_make_shardings_places_every_tree():
    """make_shardings on an abstract (16, 16) mesh: every parameter, state
    leaf, batch entry and cache has placements, and a zero1 state leaf is
    sharded over data where its parameter is not."""
    from torch.distributed.tensor import Shard
    from repro_torch.launch import step as tstep
    arch = tconfigs.get_config("qwen2-7b")
    mesh = TMesh((16, 16), ("data", "model"))
    tcommon.set_sharding_mode("zero1")
    try:
        p, o, b, c = tstep.make_shardings(arch, tconfigs.get_shape("train_4k"), mesh)
    finally:
        tcommon.set_sharding_mode("2d")
    names = dict(tstep.abstract_params(arch).named_parameters())
    assert p.keys() == names.keys() == o["leaves"].keys()
    assert b.keys() == {"tokens", "labels"} and c is None
    wo = "blocks.0.attn.wo"
    assert p[wo][0] != Shard(1) and o["leaves"][wo]["master"][0] == Shard(1)
    _, _, _, caches = tstep.make_shardings(arch, tconfigs.get_shape("decode_32k"), mesh)
    assert caches["k"][1] == Shard(2)
