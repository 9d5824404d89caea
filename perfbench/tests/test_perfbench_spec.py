"""BENCHMARK.json and the files it names: names, units, the cells each
metric is reported in, and every piece found by its name."""
from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
import textwrap

import pytest

from perfbench import spec
from perfbench.tests.helpers import ROOT

BENCH = spec.load_benchmark()
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_benchmark_is_sound():
    assert spec.problems(BENCH) == []


@pytest.mark.parametrize("name", [m["name"] for m in METRICS]
                         + [w["name"] for w in BENCH["workloads"]]
                         + [c["name"] for c in BENCH["configs"]])
def test_names_use_only_the_allowed_characters(name):
    assert spec.NAME.fullmatch(name)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_units_use_only_the_allowed_characters(metric):
    assert spec.UNIT.fullmatch(metric["unit"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_cell_of_a_per_layer_metric_reports_what_it_moves(metric):
    for cell in metric["workloads"]:
        assert metric["moves"] in {m["name"] for m in spec.metrics_for(BENCH, cell, False)}


def test_a_bad_name_and_a_moved_metric_missing_from_a_cell_are_found():
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"][0]["name"] = "bad name"
    moved = next(m for m in bench["per_layer"] if m["moves"] == "serve_tokens_per_s")
    moved["workloads"] = ["starcoder2-3b.train"]
    found = spec.problems(bench)
    assert any("bad name" in p for p in found)
    assert any("does not report serve_tokens_per_s" in p for p in found)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_each_metric_has_a_reader_found_by_name(metric):
    cells = metric.get("workloads", [w["name"] for w in BENCH["workloads"]])
    for cell in cells:
        kind = spec.load_traffic(spec.workload(BENCH, cell)["traffic"])["kind"]
        reader = spec.load_reader(metric["name"], kind)
        assert (reader.UNIT, reader.SOURCE) == (metric["unit"], metric["source"])
        assert reader.LAYER == metric.get("layer")


def test_a_split_with_no_file_reads_its_quantity_for_the_cells_kind():
    """``prefill_ms.prompt`` has no file: a serving cell reads it with
    ``prefill_ms.serve``'s reader; a kind with no reader of it is an error,
    and so is a metric with no reader at all."""
    reader = spec.load_reader("prefill_ms.prompt", "serve")
    assert reader.__file__.endswith("prefill_ms.serve.py")
    assert not (spec.HERE / "metrics" / "prefill_ms.prompt.py").exists()
    assert spec.load_reader("mfu.train", "serve").__file__.endswith("mfu.train.py")
    with pytest.raises(FileNotFoundError, match="prefill_ms.train.py"):
        spec.load_reader("prefill_ms.prompt", "train")
    with pytest.raises(FileNotFoundError, match="prefill_ms.prompt.py"):
        spec.load_reader("prefill_ms.prompt")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_config_traffic_and_limits(cell):
    file, traffic = spec.load_config(cell["config"]), spec.load_traffic(cell["traffic"])
    assert file["model_type"] and traffic["kind"] in ("serve", "train")
    assert spec.load_check(cell["name"])["limits"]
    config = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert config["file"] == f"perfbench/configs/{cell['config']}.json"
    assert sorted(config["reduced"]) == sorted(file["reduced"])
    assert set(file["reduced"]) <= set(file)
    if traffic["kind"] == "train" and "train_global_batch" in file:
        assert (traffic["batch"], traffic["seq_len"]) == (file["train_global_batch"],
                                                          file["train_seq_len"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_departures_are_in_reduced_and_apart_from_the_cuts(config):
    """What the port lacks (``departures``) differs from the source, so it
    is in ``reduced``; every key of ``reduced`` keeps its source's value."""
    file = spec.load_config(config["name"])
    assert set(file.get("departures", {})) <= set(config["reduced"])
    assert set(config["reduced"]) == set(file.get("source_values", {}))
    assert all(file[k] != v for k, v in file.get("source_values", {}).items())


def test_the_run_budget_fits_the_full_check():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= BENCH["run_seconds"] <= 51


def _digest(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_config_mix_and_metric_need_no_edit(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, limits
    and a metric as new files and entries; a tiny cell of them runs on the
    CPU and reports the new metric, and no file that was there changed."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "perfbench")
    file = spec.load_config("starcoder2-3b")
    file.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, intermediate_size=128, vocab_size=256,
                torch_dtype="float32", train_global_batch=2, train_seq_len=16)
    new = tmp_path / "perfbench"
    (new / "configs" / "tiny-coder.json").write_text(json.dumps(file))
    (new / "traffic" / "tiny-train.json").write_text(json.dumps(
        {"kind": "train", "why": "tiny", "batch": 2, "seq_len": 16, "plan": "card",
         "first_step": 100, "checked_steps": 2, "ref_block_rows": 1}))
    (new / "checks" / "tiny-coder.tiny-train.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}}))
    (new / "metrics" / "train_steps_per_s.py").write_text(textwrap.dedent('''
        LAYER, UNIT, SOURCE = None, "steps/s", "host_clock"

        def read(facts):
            return facts["steps"] / facts["window_s"] if facts["kind"] == "train" else None
    '''))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny-coder", "source": "test",
                             "file": "perfbench/configs/tiny-coder.json",
                             "reduced": file["reduced"], "why": "tiny"})
    bench["workloads"].append({"name": "tiny-coder.tiny-train", "config": "tiny-coder",
                               "traffic": "tiny-train", "chips": 1, "why": "tiny"})
    bench["end_to_end"].append({"name": "train_steps_per_s", "unit": "steps/s",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["tiny-coder.tiny-train"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("train_tokens_per_s", "mfu.train"):
            m["workloads"].append("tiny-coder.tiny-train")
    # the optimizer's time split for the new metric: an entry, no file
    bench["per_layer"].append({"name": "optimizer_ms.steps", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "optim",
                               "moves": "train_steps_per_s",
                               "workloads": ["tiny-coder.tiny-train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = textwrap.dedent(f'''
        import json, sys, time, torch
        sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT / "src")!r}]
        from perfbench import cells, spec
        assert spec.HERE == spec.ROOT / "perfbench" and str(spec.ROOT) == {str(tmp_path)!r}
        bench = spec.load_benchmark()
        assert spec.problems(bench) == [], spec.problems(bench)
        cell = spec.workload(bench, "tiny-coder.tiny-train")
        reader = spec.load_reader("optimizer_ms.steps", "train")
        assert reader.__file__.endswith("optimizer_ms.train.py"), reader.__file__
        res = cells.run_cell(bench, cell, spec.load_config("tiny-coder"),
                             spec.load_traffic("tiny-train"), spec.load_check(cell["name"]),
                             7, 0.2, False, torch.device("cpu"), time.perf_counter())
        print(json.dumps(res))
    ''')
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res
    assert set(res["metrics"]) == {"setup_s", "train_tokens_per_s", "train_steps_per_s"}
    after = _digest(new)
    assert {k: v for k, v in after.items() if k in before} == before
