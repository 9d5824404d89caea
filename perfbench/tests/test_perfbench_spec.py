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


def _new_train_cell(new, bench) -> tuple[str, str, str, float]:
    """A configuration, a train mix, limits and a metric, and the
    optimizer's time split for it as an entry with no file."""
    file = spec.load_config("starcoder2-3b")
    file.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, intermediate_size=128, vocab_size=256,
                torch_dtype="float32", train_global_batch=2, train_seq_len=16)
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
    bench["per_layer"].append({"name": "optimizer_ms.steps", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "optim",
                               "moves": "train_steps_per_s",
                               "workloads": ["tiny-coder.tiny-train"]})
    after = '''
        reader = spec.load_reader("optimizer_ms.steps", "train")
        assert reader.__file__.endswith("optimizer_ms.train.py"), reader.__file__
        assert set(res["metrics"]) == {"setup_s", "train_tokens_per_s", "train_steps_per_s"}
    '''
    return "tiny-coder.tiny-train", "", after, 0.2


# The port's MoE (models/moe.py) splits a prefill's B x P tokens into groups
# of 512 (one group where there are fewer) and gives each expert C = max(k,
# int(group k 1.25 / E)) (token, choice) pairs a group; a decode step is one
# group of the B rows with factor 2.0.  At top-2 of 4 a group of T tokens
# gives C = max(2, int(0.625 T)), and seeded weights route up to 0.64 T of
# a prompt's tokens to one expert: so the prompts here are one row of one
# or two tokens, a group in which no expert can pass C = 2, and the decode
# steps (one row, C = 2) do the rest.  The script counts, layer by layer,
# each expert's pairs in every call's prompt from the reference's router
# and holds them to C.
MOE = {"num_local_experts": 4, "num_experts_per_tok": 2}
MOE_BATCH, MOE_PROMPT = 1, [2, 1]


def _new_routed_serve_cell(new, bench) -> tuple[str, str, str, float]:
    """A routed-expert form, its configuration, a serve mix whose prompt
    length is drawn per call, and limits."""
    shutil.copy(ROOT / "perfbench" / "tests" / "tiny_moe_form.py", new / "forms" / "mixtral.py")
    # rms_norm_eps as the port runs it: its RMSNorm takes 1e-6 whatever the
    # config states (Mixtral publishes 1e-5)
    file = {"arch": "mixtral-8x22b", "model_type": "mixtral", "hidden_act": "silu",
            "hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 2,
            "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 256,
            "rms_norm_eps": 1e-6, "rope_theta": 1e6, "sliding_window": None,
            "tie_word_embeddings": False, "torch_dtype": "float32", "reduced": [], **MOE}
    (new / "configs" / "tiny-moe.json").write_text(json.dumps(file))
    (new / "traffic" / "tiny-chat.json").write_text(json.dumps(
        {"kind": "serve", "why": "tiny", "batch": MOE_BATCH,
         "prompt_len": {"shuffled": MOE_PROMPT}, "gen": 12, "sample_rows": 3,
         "ref_block_rows": 2}))
    (new / "checks" / "tiny-moe.tiny-chat.json").write_text(json.dumps(
        {"limits": {"logit_gap": 1e-4}}))
    bench["configs"].append({"name": "tiny-moe", "source": "test",
                             "file": "perfbench/configs/tiny-moe.json", "reduced": [],
                             "why": "tiny"})
    bench["workloads"].append({"name": "tiny-moe.tiny-chat", "config": "tiny-moe",
                               "traffic": "tiny-chat", "chips": 1, "why": "tiny"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("serve_tokens_per_s", "itl_ms_p95", "mfu.serve"):
            m["workloads"].append("tiny-moe.tiny-chat")
    # the host clock advances 1 ms a read: the window holds the same calls
    # however loaded the CPU is
    before = f'''
        import dataclasses, itertools
        ticks = itertools.count()
        time.perf_counter = lambda: next(ticks) * 1e-3
        import repro_torch.configs as configs
        import repro_torch.launch.serve as serve_mod
        from perfbench.modelspec import spec_of
        from perfbench.program import port_model
        real = configs.get_config
        def get_config(name):
            arch = real(name)
            if name != "mixtral-8x22b":
                return arch
            m = spec_of(name, spec.load_config("tiny-moe"))
            return dataclasses.replace(arch, model=port_model(m, arch.model))
        configs.get_config = serve_mod.get_config = get_config
    '''
    after = f'''
        from perfbench import serve_cell, weights as W
        from perfbench.modelspec import form_of
        from perfbench.reference import model as ref_model
        m = spec_of("tiny-moe", spec.load_config("tiny-moe"))
        form, traffic, chosen = form_of(m), spec.load_traffic("tiny-chat"), []
        real_route = form.route
        def route(p, h, m, mm):
            gates, experts = real_route(p, h, m, mm)
            chosen.append(experts)
            return gates, experts
        form.route = route
        k, e = {MOE["num_experts_per_tok"]}, {MOE["num_local_experts"]}
        assert max(k, int({MOE_BATCH} * k * 2.0 / e)) >= {MOE_BATCH}  # no decode drops
        calls = res["attempted"] // {MOE_BATCH}
        shapes = [serve_cell.call_shape(traffic, 7, i) for i in range(calls)]
        assert len(shapes) > 1 and len({{s["prompt_len"] for s in shapes}}) > 1, shapes
        for i, s in enumerate(shapes):
            tokens = s["batch"] * s["prompt_len"]
            assert tokens <= 512, tokens  # one group
            cap = max(k, int(tokens * k * 1.25 / e))
            chosen.clear()
            ids = W.tokens(7, "prompt", i, (s["batch"], s["prompt_len"]), m.vocab,
                           torch.device("cpu"))
            ref_model.served_logits(m, 7, ids, s["prompt_len"] - 1, block_rows=s["batch"])
            assert len(chosen) == m.layers
            for layer in chosen:
                most = int(torch.bincount(layer.flatten(), minlength=e).max())
                assert most <= cap, (i, most, cap)
        assert set(res["metrics"]) == {{"setup_s", "serve_tokens_per_s", "itl_ms_p95"}}
    '''
    return "tiny-moe.tiny-chat", before, after, 0.5


@pytest.mark.parametrize("case", ["a train mix and a metric",
                                  "a routed-expert form and a per-call serve mix"])
def test_a_new_config_mix_and_metric_need_no_edit(tmp_path, case):
    """A copy of the benchmark gains, as new files and entries, a
    configuration, a traffic mix and limits, and a metric or a form; a tiny
    cell of them runs on the CPU and is correct, and no file that was there
    changed."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = tmp_path / "perfbench"
    before = _digest(new)
    bench = json.loads(json.dumps(BENCH))
    add = _new_train_cell if case == "a train mix and a metric" else _new_routed_serve_cell
    cell, setup, after, seconds = add(new, bench)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = textwrap.dedent(f'''
        import json, sys, time, torch
        sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT / "src")!r}]
        from perfbench import cells, spec
        assert spec.HERE == spec.ROOT / "perfbench" and str(spec.ROOT) == {str(tmp_path)!r}
        bench = spec.load_benchmark()
        assert spec.problems(bench) == [], spec.problems(bench)
        cell = spec.workload(bench, {cell!r})
    ''') + textwrap.dedent(setup) + textwrap.dedent(f'''
        res = cells.run_cell(bench, cell, spec.load_config(cell["config"]),
                             spec.load_traffic(cell["traffic"]), spec.load_check(cell["name"]),
                             7, {seconds}, False, torch.device("cpu"), time.perf_counter())
    ''') + textwrap.dedent(after) + "print(json.dumps(res))\n"
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res
    after = _digest(new)
    assert {k: v for k, v in after.items() if k in before} == before
