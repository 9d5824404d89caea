"""Serve traffic's shapes: a number, or for the batch and the prompt
length a ``shuffled`` list.  Draws repeat across runs of one seed;
``shuffled`` serves every value once a round; a window holds whole rounds;
a file of plain numbers makes the calls, the sample and the rows that the
harness made before shapes could be drawn (the old code kept here as the
reference)."""
from __future__ import annotations

import collections
import itertools
import random
import time

import pytest
import torch

from perfbench import check, serve_cell, spec
from perfbench import weights as W
from perfbench.modelspec import spec_of
from perfbench.reference import model as ref_model
from perfbench.tests.helpers import tiny_file

CPU = torch.device("cpu")
DRAWN = {"batch": {"shuffled": [8, 8, 4, 4, 2]}, "prompt_len": {"shuffled": [100, 110, 120, 130, 140]},
         "gen": 16}
PAIRS = {(8, 100), (8, 110), (4, 120), (4, 130), (2, 140)}


def _shapes(traffic, seed, n=30):
    return [serve_cell.call_shape(traffic, seed, i) for i in range(n)]


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 3_000_000_001])
def test_draws_repeat_across_runs_of_one_seed(seed):
    first = _shapes(DRAWN, seed)
    assert _shapes(dict(DRAWN), seed) == first
    assert all((s["batch"], s["prompt_len"]) in PAIRS and s["gen"] == 16 for s in first)
    assert _shapes(DRAWN, seed + 1) != first


def test_shuffled_serves_every_value_once_a_round_in_an_order_of_the_seed():
    orders = set()
    assert len(serve_cell.round_shapes(DRAWN)) == 5
    for seed in range(20):
        shapes = [(s["batch"], s["prompt_len"]) for s in _shapes(DRAWN, seed, 20)]
        rounds = [shapes[i:i + 5] for i in range(0, 20, 5)]
        assert all(set(r) == PAIRS for r in rounds)
        orders.add(tuple(rounds[0]))
    assert len(orders) > 3


def test_a_draw_of_one_key_leaves_the_others_alone():
    fixed = {**DRAWN, "batch": 4}
    assert len(serve_cell.round_shapes(fixed)) == 5
    assert ([s["prompt_len"] for s in _shapes(fixed, 5)]
            == [s["prompt_len"] for s in _shapes(DRAWN, 5)])
    assert {s["batch"] for s in _shapes(fixed, 5)} == {4}


def test_the_largest_shape_warms_the_largest_call():
    assert serve_cell.largest_shape(DRAWN) == {"batch": 8, "prompt_len": 110, "gen": 16}
    assert serve_cell.largest_shape({**DRAWN, "batch": 8}) == {
        "batch": 8, "prompt_len": 140, "gen": 16}
    with pytest.raises(ValueError, match="differ in length"):
        serve_cell.round_shapes({**DRAWN, "batch": {"shuffled": [2, 4]}})
    assert serve_cell.largest_shape(spec.load_traffic("decode")) == {
        "batch": 16, "prompt_len": 1024, "gen": 256}
    for bad in ({**DRAWN, "gen": {"shuffled": [16, 32]}},
                {**DRAWN, "prompt_len": {"uniform": [100, 140]}},
                {**DRAWN, "batch": {"choice": [2, 4]}}):
        with pytest.raises(ValueError, match="a shape is a number"):
            serve_cell.call_shape(bad, 0, 0)


@pytest.mark.parametrize("mix", ["decode", "prefill"])
def test_a_plain_file_draws_its_numbers_for_every_call(mix):
    traffic = spec.load_traffic(mix)
    want = {k: traffic[k] for k in serve_cell.SHAPES}
    assert _shapes(traffic, 2**31 + 3) == [want] * 30


def _old_sample(seed: int, n_calls: int, batch: int, k: int):
    rng = random.Random(W.seed_of(seed, "sample"))
    pairs = [(c, r) for c in range(n_calls) for r in range(batch)]
    return sorted(rng.sample(pairs, min(k, len(pairs))))


@pytest.mark.parametrize("n_calls, batch, k", [(1, 16, 4), (7, 16, 4), (30, 8, 32), (3, 2, 64)])
def test_a_plain_file_samples_the_rows_it_sampled_before(n_calls, batch, k):
    calls = [{"batch": batch, "prompt_len": 1024, "gen": 256}] * n_calls
    for seed in (1, 2**31 + 5, 3_000_000_201):
        assert serve_cell.sample(seed, calls, k) == _old_sample(seed, n_calls, batch, k)


def test_a_sample_of_calls_that_differ_holds_one_of_the_longest():
    calls = [{"batch": 64, "prompt_len": 768 + (i == 6) * 256, "gen": 256} for i in range(10)]
    for seed in range(40):
        rows = serve_cell.sample(seed, calls, 4)
        assert len(set(rows)) == 4 and any(c == 6 for c, _ in rows)


def test_a_plain_file_makes_the_calls_and_the_check_it_made_before(tiny_port, monkeypatch):
    """The decode mix at a tiny size: each call serves the same batch of
    the seed's prompts as before, and the reference's gap over the sampled
    rows is the old rows' gap, bit for bit.  The host clock advances 1 ms a
    read, so the window holds the same calls however loaded the CPU is."""
    import repro_torch.launch.serve as serve_mod

    file = tiny_file("qwen2-7b")
    m = spec_of("qwen2-7b", file)
    traffic = {**spec.load_traffic("decode"), "batch": 3, "prompt_len": 12, "gen": 5,
               "sample_rows": 5}
    seed, seen, real = 2**31 + 21, [], serve_mod.serve

    def serve(*args, **kwargs):
        seen.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(serve_mod, "serve", serve)
    ticks = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks) * 1e-3)
    facts, numbers = serve_cell.run(m, file, traffic, seed, 0.3, False, CPU, time.perf_counter())
    calls = facts["served_calls"]
    assert len(seen) == len(calls) > 1
    for i, kw in enumerate(seen):
        assert (kw["batch"], kw["prompt_len"], kw["gen"]) == (3, 12, 5)
        assert torch.equal(kw["prompts"][0]["tokens"],
                           W.tokens(seed, "prompt", i, (3, 12), m.vocab, CPU))
    assert facts["generated"] == len(calls) * 3 * 5
    assert facts["prompt_tokens"] == len(calls) * 3 * 12
    assert facts["attempted"] == len(calls) * 3
    # the old rows: the prompts and served tokens of each sampled row, one length
    rows = _old_sample(seed, len(calls), 3, 5)
    prompts = {c: W.tokens(seed, "prompt", c, (3, 12), m.vocab, CPU) for c, _ in rows}
    served = torch.stack([torch.as_tensor(calls[c]["tokens"][r]) for c, r in rows])
    ids = torch.cat([torch.stack([prompts[c][r] for c, r in rows]), served.to(torch.int32)], 1)
    logits = ref_model.served_logits(m, seed, ids[:, :-1], 11, block_rows=4)
    assert numbers["logit_gap"] == float(check.logit_gaps(logits, served).max())


@pytest.mark.parametrize("seconds", [0.02, 0.05, 0.11])
def test_a_window_holds_whole_rounds(tiny_port, monkeypatch, seconds):
    """A window that its seconds would end inside a round runs on to the
    round's end: every length is served as often as every other, whatever
    the seed and the speed.  The host clock advances 1 ms a read."""
    file = tiny_file("qwen2-7b")
    m = spec_of("qwen2-7b", file)
    traffic = {**spec.load_traffic("decode-wide"), "batch": 2,
               "prompt_len": {"shuffled": [9, 12, 15]}, "gen": 4, "sample_rows": 2}
    ticks = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks) * 1e-3)
    facts, _ = serve_cell.run(m, file, traffic, 2**31 + 9, seconds, False, CPU,
                              time.perf_counter())
    calls = facts["served_calls"]
    assert facts["window_s"] >= seconds and len(calls) % 3 == 0
    lengths = collections.Counter(c["prompt_len"] for c in calls)
    assert set(lengths) == {9, 12, 15} and len(set(lengths.values())) == 1
    assert facts["generated"] == len(calls) * 2 * 4
