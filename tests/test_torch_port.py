"""The rules of the PyTorch port (``src/repro_torch``): it imports neither
JAX nor the JAX package, runs on the card unless asked for the CPU, takes
its plain versions only for CPU tensors, and carries JAX arrays across
exactly."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro_torch import device as port_device  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.interop import to_torch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.umbench.apps import (  # noqa: E402
    bfs, black_scholes, cg, conv_fft, fdtd3d, matmul)

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
APPS = (bfs, black_scholes, cg, conv_fft, fdtd3d, matmul)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_import_scan_tells_repro_from_repro_torch():
    assert _forbidden("repro") and _forbidden("repro.kernels.black_scholes")
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert not _forbidden("repro_torch") and not _forbidden("repro_torch.kernels")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_repro(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_port_runs_with_jax_blocked():
    """With JAX made unimportable, the port imports and computes on the
    CPU, and nothing of the JAX package gets loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch.kernels, repro_torch.interop\n"
        "from repro_torch.umbench.apps import bfs, black_scholes, cg, conv_fft, fdtd3d, matmul\n"
        "out = fdtd3d.numeric(shape=(8, 16, 40), steps=1, device='cpu')\n"
        "assert out['out'].shape == (8, 16, 40)\n"
        "black_scholes.numeric(n=64, device='cpu')\n"
        "import repro_torch.core, repro_torch.data, repro_torch.models, repro_torch.runtime\n"
        "import repro_torch.launch.mesh, repro_torch.launch.sharding, repro_torch.launch.step\n"
        "import repro_torch.launch.analysis, repro_torch.launch.dryrun, repro_torch.launch.perf\n"
        "import repro_torch.bench.roofline\n"
        "from repro_torch.launch.serve import serve\n"
        "for arch in ('qwen2-7b', 'rwkv6-3b', 'hymba-1.5b', 'mixtral-8x22b'):\n"
        "    toks = serve(arch, batch=2, prompt_len=4, gen=3, device='cpu')\n"
        "    assert toks.shape == (2, 3)\n"
        "import tempfile\n"
        "from repro_torch.launch.train import train\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    _, report = train('starcoder2-3b', steps=3, batch=2, seq=8, ckpt_dir=d,\n"
        "                      checkpoint_every=2, device='cpu')\n"
        "assert report.steps_completed == 3 and len(report.losses) == 3\n"
        "loaded = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


@pytest.mark.parametrize("app", APPS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_numeric_defaults_to_the_card(app):
    """``device=None`` means CUDA; with no card it raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is taken")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.numeric()


def _no_card_entry_points():
    from repro_torch.configs import MeshConfig, ShapeConfig, get_config
    from repro_torch.core.advise import MemorySpace
    from repro_torch.core.placement import to_device_space
    from repro_torch.core.prefetch import PrefetchIterator
    from repro_torch.core.residency import MemoryBudget, ResidencyPlan, ResidencyPlanner
    from repro_torch.data import prefetched
    from repro_torch.examples import train_lm
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.launch.step import build_train_step
    from repro_torch.launch.train import train
    from repro_torch.runtime import plan_elastic_mesh

    arch = get_config("qwen2-7b")
    cfg = arch.model.reduce()
    host = ResidencyPlan(arch.name, "t", MeshConfig(), MemoryBudget(),
                         opt_space=MemorySpace.HOST)
    shape = ShapeConfig("t", 4, 1, "train")
    return {"serve": lambda: serve("qwen2-7b", batch=1, prompt_len=2, gen=1),
            "prefetched": lambda: prefetched(cfg, shape),
            "PrefetchIterator": lambda: PrefetchIterator(iter([])),
            "to_device_space": lambda: to_device_space(torch.ones(2)),
            "train": lambda: train("qwen2-7b", steps=1, batch=1, seq=4),
            "build_train_step_host": lambda: build_train_step(arch, shape, None, host),
            "ResidencyPlanner": lambda: ResidencyPlanner(),
            "train_lm": lambda: train_lm.main(["--steps", "2"]),
            "make_test_mesh": lambda: make_test_mesh((1, 1)),
            "plan_elastic_mesh": lambda: plan_elastic_mesh(arch, shape, 8)}


@pytest.mark.parametrize("name", ["serve", "prefetched", "PrefetchIterator",
                                  "to_device_space", "train", "build_train_step_host",
                                  "ResidencyPlanner", "train_lm", "make_test_mesh",
                                  "plan_elastic_mesh"])
def test_movement_and_serve_default_to_the_card(name):
    """With no device given, the slice's entry points take the card, and
    raise without one instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is taken")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _no_card_entry_points()[name]()


def test_no_memory_kinds_on_the_cpu():
    from repro_torch.core.placement import backend_supports_memory_kinds

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert backend_supports_memory_kinds() is False
    assert backend_supports_memory_kinds("cpu") is False
    with pytest.raises(ValueError, match="meta"):
        backend_supports_memory_kinds("meta")


def test_resolve_takes_an_explicit_device():
    assert port_device.resolve("cpu") == torch.device("cpu")


def test_cpu_tensors_leave_launch_counters_at_zero():
    counters = (tk.black_scholes, tk.matmul, tk.fdtd3d_step)
    for fn in counters:
        fn.launches = 0
    v = torch.rand(16) + 1.0
    tk.black_scholes(v, v, v)
    tk.matmul(torch.ones(4, 3), torch.ones(3, 2))
    coef = torch.tensor([0.5, 0.1, 0.05, 0.02, 0.01])
    tk.fdtd3d_step(torch.ones(8, 8, 8), coef)
    tk.fdtd3d_run(torch.ones(8, 8, 8), coef, steps=3)
    for app in (black_scholes, matmul, fdtd3d):
        app.numeric(device="cpu")
    assert [fn.launches for fn in counters] == [0, 0, 0]


def test_no_fallback_off_the_cpu():
    """A tensor that is on neither the CPU nor a CUDA card is refused, not
    sent to the plain version."""
    m = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.black_scholes(m, m, m)
    with pytest.raises(ValueError, match="CUDA"):
        tk.matmul(torch.empty(4, 4, device="meta"), torch.empty(4, 4, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tk.fdtd3d_run(torch.empty(8, 8, 8, device="meta"),
                      torch.empty(5, device="meta"), steps=1)


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        tk.black_scholes(torch.ones(3), torch.ones(4), torch.ones(3))
    with pytest.raises(ValueError):
        tk.matmul(torch.ones(2, 3), torch.ones(4, 2))
    with pytest.raises(ValueError):
        tk.fdtd3d_step(torch.ones(8, 8), torch.ones(5))
    with pytest.raises(ValueError):
        tk.fdtd3d_run(torch.ones(8, 8, 8), torch.ones(5), steps=-1)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """With no compiler the build raises; there is no quiet fallback."""
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "missing.so")
    _build.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.library()
    finally:
        _build.library.cache_clear()


def test_library_name_follows_the_sources():
    path = _build.library_path()
    assert path.parent == REPO / "build" / "torch_kernels"
    assert path == _build.library_path()
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == [
        "black_scholes.cu", "errors.cu", "fdtd3d.cu", "flash_attention.cu",
        "paged_attention.cu", "streamed_matmul.cu"]


def test_library_name_follows_the_headers(monkeypatch, tmp_path):
    """An edit to a shared header, such as hopper_common.cuh, names a new
    library, so that the kernels are built again."""
    for src in _build.CSRC.glob("*.cu*"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    header = tmp_path / "hopper_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path() != before


@pytest.mark.parametrize("dtype", [np.float32, np.int32, jnp.bfloat16])
def test_to_torch_round_trips(dtype):
    src = jnp.asarray(np.arange(-6, 6).reshape(3, 4) * 1.5, dtype)
    t = to_torch(np.asarray(src), "cpu")
    assert t.shape == (3, 4)
    if dtype is jnp.bfloat16:
        assert t.dtype == torch.bfloat16
        back = t.view(torch.int16).numpy().view(jnp.bfloat16)
    else:
        back = t.numpy()
    np.testing.assert_array_equal(back, np.asarray(src))
    assert back.dtype == np.asarray(src).dtype


def test_to_torch_walks_trees():
    tree = {"a": [jnp.ones(2), (np.zeros(3, np.int32), 7)], "b": "x", "c": None}
    out = to_torch(tree, "cpu")
    assert isinstance(out["a"], list) and isinstance(out["a"][1], tuple)
    assert torch.equal(out["a"][0], torch.ones(2))
    assert out["a"][1][0].dtype == torch.int32
    assert out["a"][1][1] == 7 and out["b"] == "x" and out["c"] is None
