"""The port's dry-run and roofline layer (``repro_torch.launch.dryrun``,
``launch/analysis.py``, ``launch/perf.py``, ``bench/roofline.py``) against
the JAX package.

The dry-run runs in a subprocess, so that the fake process group never
lives in the pytest process: ``run_cell`` on reduced configs over a fake
(2, 4) mesh, train and decode.  The analysis functions are compared
exactly (the same Python arithmetic); ``Roofline.as_dict()`` against JAX's
once a monkeypatch has set JAX's module constants to the H100's."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import analysis as janalysis  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bench import roofline as troof  # noqa: E402
from repro_torch.launch import analysis as tanalysis  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
RECORD_KEYS = {"arch", "shape", "mesh", "multi_pod", "chips", "status", "residency_plan",
               "compile_s", "memory_analysis", "cost_analysis_raw", "collectives_raw",
               "probes", "roofline"}
MEMORY_KEYS = {"argument_gb", "output_gb", "temp_gb", "alias_gb", "peak_extra_gb"}

DRYRUN = r"""
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
out = {}
for name, shape, layers in (("qwen2-7b", "train_4k", 4), ("qwen2-7b", "decode_32k", 2),
                            ("mixtral-8x22b", "train_4k", 2), ("rwkv6-3b", "decode_32k", 2)):
    arch = get_config(name)
    arch = dataclasses.replace(arch, model=dataclasses.replace(arch.model.reduce(),
                                                               num_layers=layers))
    out[f"{name}/{shape}"] = dryrun.run_cell(name, shape, multi_pod=False, arch=arch,
                                             mesh_shape=(2, 4), outdir=sys.argv[1])
# launch/perf.py on the production mesh, a reduced qwen2-7b in pure FSDP
from repro_torch.launch import perf
reduced = dataclasses.replace(get_config("qwen2-7b"),
                              model=get_config("qwen2-7b").model.reduce())
perf.get_config = lambda name: reduced
out["perf"] = perf.measure("qwen2-7b", "train_4k", tag="fsdp", sharding_mode="fsdp",
                           microbatches=2, remat="none", outdir=sys.argv[1] + "/perf")
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    r = subprocess.run([sys.executable, "-c", DRYRUN, str(out)], capture_output=True,
                       text=True, timeout=600, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2"))
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1]), out


@pytest.mark.parametrize("cell", ["qwen2-7b/train_4k", "qwen2-7b/decode_32k",
                                  "mixtral-8x22b/train_4k", "rwkv6-3b/decode_32k"])
def test_dryrun_cell_is_ok_with_the_reference_keys(records, cell):
    rec = records[0][cell]
    assert rec["status"] == "ok", rec.get("error")
    assert set(rec) == RECORD_KEYS, set(rec) ^ RECORD_KEYS
    assert set(rec["memory_analysis"]) == MEMORY_KEYS
    assert rec["mesh"] == "2x4" and rec["chips"] == 8
    mem = rec["memory_analysis"]
    assert mem["argument_gb"] > 0 and mem["peak_extra_gb"] >= 0
    assert rec["cost_analysis_raw"]["flops"] > 0 and rec["cost_analysis_raw"]["bytes_accessed"] > 0
    assert set(rec["roofline"]) == set(janalysis.Roofline(
        "a", "s", "m", 1, 1.0, 1.0, 1.0, 1.0).as_dict())


@pytest.mark.parametrize("cell", ["qwen2-7b/train_4k", "mixtral-8x22b/train_4k"])
def test_train_step_has_a_gradient_collective(records, cell):
    """The counterpart of test_data_parallel_gradient_sync_present."""
    counts = records[0][cell]["collectives_raw"]["counts"]
    assert counts.get("all-reduce", 0) + counts.get("reduce-scatter", 0) > 0, counts


def test_probes_extrapolate_to_the_full_trace(records):
    """A dense stack of identical layers: the L=1/L=2 probes extrapolate to
    4 layers exactly what the 4-layer trace counts."""
    rec = records[0]["qwen2-7b/train_4k"]
    p1, p2 = rec["probes"]["L1"], rec["probes"]["L2"]
    for key, raw in (("flops", "flops"), ("bytes", "bytes_accessed")):
        assert tanalysis.extrapolate(p1[key], p2[key], 4) == rec["cost_analysis_raw"][raw]
    assert rec["roofline"]["hlo_flops_per_chip"] == rec["cost_analysis_raw"]["flops"]


def test_roofline_rows_over_the_artifacts(records):
    rows = troof.roofline_rows("2x4", artifacts=records[1])
    assert rows[0].startswith("table,arch,shape,mesh,status")
    assert len(rows) == 1 + 4 and all(",ok," in r for r in rows[1:])
    assert len(troof.dryrun_rows(records[1])) == 1 + 4
    assert troof.roofline_rows("16x16", artifacts=records[1]) == rows[:1]


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_analysis_functions_match_jax(arch):
    ja, ta = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for shape in SHAPES:
        js, ts = jconfigs.get_shape(shape), tconfigs.get_shape(shape)
        assert tanalysis.model_flops(ta, ts) == janalysis.model_flops(ja, js)
        assert tanalysis.wkv_correction_flops(ta, ts) == janalysis.wkv_correction_flops(ja, js)
    for a, b, L in ((1.0, 3.0, 30), (5e12, 7.5e12, ta.model.num_layers), (2.0, 2.0, 1)):
        assert tanalysis.extrapolate(a, b, L) == janalysis.extrapolate(a, b, L)


@pytest.mark.parametrize("terms", [(1e15, 1e12, 1e9), (1e12, 1e13, 1e9), (1e9, 1e9, 1e12),
                                   (0.0, 0.0, 0.0)])
def test_roofline_matches_jax_at_the_h100_constants(monkeypatch, terms):
    monkeypatch.setattr(janalysis, "PEAK_FLOPS", tanalysis.PEAK_FLOPS)
    monkeypatch.setattr(janalysis, "HBM_BW", tanalysis.HBM_BW)
    monkeypatch.setattr(janalysis, "ICI_BW", tanalysis.LINK_BW)
    args = ("starcoder2-3b", "train_4k", "16x16", 256, *terms, 1.9e16)
    assert tanalysis.Roofline(*args).as_dict() == janalysis.Roofline(*args).as_dict()


def test_h100_constants():
    """The H100 SXM's data-sheet rates (PERF.md section 2), and the
    inter-node link beside NVLink's."""
    assert (tanalysis.PEAK_FLOPS, tanalysis.HBM_BW) == (989e12, 3.35e12)
    assert (tanalysis.LINK_BW, tanalysis.NVLINK_BW) == (50e9, 450e9)


def test_collective_stats_keep_the_reference_formula():
    counts = {"all-gather": 1, "all-reduce": 2, "reduce-scatter": 1, "all-to-all": 1,
              "collective-permute": 1}
    out = {"all-gather": 10, "all-reduce": 20, "reduce-scatter": 30, "all-to-all": 40,
           "collective-permute": 50}
    t = tanalysis.CollectiveStats(dict(counts), dict(out))
    j = janalysis.CollectiveStats(dict(counts), dict(out))
    assert t.link_bytes == j.link_bytes == 10 + 40 + 30 + 40 + 50
    assert t.as_dict() == j.as_dict()


def test_trace_counter_counts_a_plain_step():
    """FLOPs of a matmul and its backward, bytes, and the live peak."""
    x = torch.randn(8, 16, requires_grad=True)
    w = torch.randn(16, 4, requires_grad=True)
    c = tanalysis.TraceCounter()
    c.track((x, w))
    with c:
        y = (x @ w).sum()
        y.backward()
    assert c.flops == 2 * 8 * 16 * 4 * 3   # forward, grad x, grad w
    assert c.bytes > 0 and c.peak >= (8 * 16 + 16 * 4) * 4
    assert c.collectives().counts == {}


def test_perf_measure_runs_a_variant(records):
    """``perf.measure`` traces the cell under its variant settings (here
    pure FSDP, 2 microbatches, no remat) and records them beside the
    roofline; the sharding mode is put back after."""
    rec = records[0]["perf"]
    assert (rec["sharding_mode"], rec["microbatches"], rec["remat"]) == ("fsdp", 2, "none")
    assert set(rec["memory_analysis"]) == MEMORY_KEYS
    assert rec["roofline"]["mesh"] == "16x16" and rec["roofline"]["chips"] == 256
    assert rec["roofline"]["hlo_flops_per_chip"] > 0
    assert (Path(records[1]) / "perf" / "qwen2-7b_train_4k_fsdp.json").exists()


@pytest.mark.parametrize("cell", ["qwen2-7b/train_4k", "mixtral-8x22b/train_4k"])
def test_collective_sites_name_their_cause(records, cell):
    """Each counted collective is filed under the DTensor operation or
    redistribution that asked for it, the port's call site and its operand:
    the sites are in the record, ordered by link bytes, and add up to the
    cell's link bytes."""
    raw = records[0][cell]["collectives_raw"]
    sites = raw["sites"]
    assert sites and all(set(s) == {"kind", "op", "site", "operand", "count", "out_bytes",
                                        "link_bytes"}
                         for s in sites)
    assert [s["link_bytes"] for s in sites] == sorted((s["link_bytes"] for s in sites),
                                                      reverse=True)
    assert sum(s["link_bytes"] for s in sites) == raw["link_bytes"]
    assert sum(s["count"] for s in sites) == sum(raw["counts"].values())
    assert all(s["site"] != "-" and ".py:" in s["site"] for s in sites)
    assert any(s["op"] != "-" for s in sites)


def test_dtensor_planning_targets_exist():
    """The two private DTensor methods that the trace wraps, to keep
    DTensor's planning runs out of the counts, exist in this torch."""
    targets = tanalysis.planning_targets()
    assert [name for _, name in targets] == ["_propagate_tensor_meta_non_cached",
                                             "local_shard_size_and_offset"]
    raw = [cls.__dict__[name] for cls, name in targets]
    with tanalysis.dtensor_planning():
        with tanalysis.dtensor_planning(host_index_math=True):
            assert all(cls.__dict__[name] is not r for (cls, name), r in zip(targets, raw))
        assert all(cls.__dict__[name] is not r for (cls, name), r in zip(targets, raw))
    assert all(cls.__dict__[name] is r for (cls, name), r in zip(targets, raw))


def test_dtensor_planning_raises_when_a_target_is_gone(monkeypatch):
    """A torch without one of the wrapped methods fails loudly, so that the
    counts never silently take DTensor's planning for the step's work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    monkeypatch.delattr(ShardingPropagator, "_propagate_tensor_meta_non_cached")
    with pytest.raises(RuntimeError, match="_propagate_tensor_meta_non_cached"):
        with tanalysis.dtensor_planning():
            pass
    with pytest.raises(RuntimeError):
        with tanalysis.TraceCounter():
            pass
