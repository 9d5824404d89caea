"""No module that the benchmark or its reference runs is ``jax`` or the
JAX package ``repro``, compared by whole top-level names; the reference
imports nothing of the port either; the command refuses a machine with no
card."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from perfbench import guard
from perfbench.tests.helpers import ROOT

PKG = ROOT / "perfbench"


@pytest.mark.parametrize("modules, found", [
    ({"repro_torch", "repro_torch.launch.serve", "reprox"}, []),
    ({"repro", "repro_torch"}, ["repro"]),
    ({"repro.core.simulator"}, ["repro"]),
    ({"jax.numpy", "jaxlib.xla_client", "flax.linen"}, ["flax", "jax", "jaxlib"]),
    ({"jaxtyping", "flaxen"}, []),
])
def test_top_level_names_are_compared_whole(modules, found):
    assert guard.forbidden(modules) == found


def _imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return {guard.top_level(n) for n in names}


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & guard.FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py"))
                         + sorted((PKG / "forms").glob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_the_reference_imports_nothing_of_the_port(path):
    """The reference and the forms, whose layers are the reference's."""
    assert "repro_torch" not in _imports(path)


def _loaded_by(code: str) -> dict:
    script = (f"import sys, json; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
              f"{code}\nprint(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_harness_and_the_port_load_no_jax():
    loaded = _loaded_by("import perfbench.cells, perfbench.control\n"
                        "import repro_torch.launch.serve, repro_torch.launch.step")
    assert guard.forbidden(loaded) == []


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded_by("import perfbench.reference.model, perfbench.reference.train, "
                        "perfbench.check, perfbench.bounds, perfbench.forms.qwen2, "
                        "perfbench.forms.starcoder2")
    assert not {guard.top_level(n) for n in loaded} & (guard.FORBIDDEN | {"repro_torch"})


def test_the_command_refuses_a_machine_without_a_card():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "qwen2-7b.decode",
                          "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    if out.returncode == 0:
        pytest.skip("this machine has a CUDA card")
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA card" in out.stderr
