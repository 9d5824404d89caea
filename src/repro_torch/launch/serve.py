"""Batched serving driver: prefill + decode loop with greedy sampling.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --batch 4 --prompt-len 32 --gen 16 [--device cpu]

The counterpart of ``repro.launch.serve``, for all ten configs: prefill ->
stacked caches -> decode loop (ring-buffer caches for SWA archs; recurrent
state for rwkv and hymba), on the card unless the caller asks for the CPU.  Random weights come from a seeded
``torch.Generator`` (they cannot match ``jax.random``'s; ``params=`` takes
weights carried across from JAX), and so do the vlm family's stub prompt
embeddings.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import spans
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.device import resolve, same_device
from repro_torch.launch.step import build_prefill_step, build_serve_step
from repro_torch.models import init_caches, init_params


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _prompt_batch(cfg, prompts, batch: int, prompt_len: int, dev) -> dict:
    """The first batch of ``prompts`` (e.g. ``data.pipeline.prefetched``):
    its embeddings (and M-RoPE positions) for the vlm family, else its
    tokens, each (batch, prompt_len, ...) and moved to ``dev``."""
    b = next(iter(prompts))
    keys = ("embeds", "positions_thw") if cfg.family == "vlm" and "embeds" in b else ("tokens",)
    out = {k: torch.as_tensor(b[k]).to(dev) for k in keys if k in b}
    for k, v in out.items():
        if tuple(v.shape[:2]) != (batch, prompt_len):
            raise ValueError(f"serve: prompts[{k!r}] is {tuple(v.shape)}, want "
                             f"({batch}, {prompt_len}, ...)")
    return out


def rehome_caches(cfg, caches_prompt: dict, batch: int, max_seq: int, device) -> dict:
    """The caches of a prefill, made ready to decode up to ``max_seq``
    positions, as the reference's serve does: K/V copied into zero caches
    of ``max_seq`` (or window) positions, the prompt's last ones first; the
    recurrent states (rwkv's shifts and WKV state, hybrid's Mamba conv and
    SSM states) as the prefill left them."""
    if cfg.family == "ssm":
        return caches_prompt  # recurrent state is position-independent
    caches = init_caches(cfg, batch, max_seq, device)
    s_cache = min(caches["k"].shape[2], caches_prompt["k"].shape[2])
    for key in ("k", "v"):
        caches[key][:, :, :s_cache] = caches_prompt[key][:, :, -s_cache:]
    for key in ("conv", "ssm"):
        if key in caches:
            caches[key] = caches_prompt[key]
    return caches


def serve(arch_name: str, *, reduced: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 16, seed: int = 0, device=None,
          params=None, prompts=None, teacher=None, record: dict | None = None,
          keep_logits: bool = False):
    """Prefill ``batch`` prompts of ``prompt_len`` tokens, then decode
    ``gen`` tokens greedily; returns them, (batch, gen) or (batch, gen, K),
    as NumPy.

    ``params``: a ``Transformer`` on the device (default: seeded random
    weights), which may have fewer blocks than the config has layers.
    ``prompts``: an iterable of batches whose first one holds the prompts
    (default: the reference's seeded NumPy tokens).
    ``teacher``: tokens (batch, gen, ...) fed to the decode steps in place
    of the generated ones (teacher forcing).  ``record``: a dict that gets
    ``prefill_ms`` (the whole cold prefill call, its capture included, and
    the caches' re-homing), ``prefill_capture_ms`` (the prefill step's CUDA
    graph), ``capture_ms`` (the decode step's; both 0 on the CPU),
    ``decode_ms_per_token`` and ``tokens_per_s`` (the decode loop), each the
    host time of the call's spans, the device synchronised; with
    ``keep_logits`` also ``logits``, the prefill's last-position logits
    followed by a copy of each decode step's.

    Spans (``repro_torch.spans``, kept while a recording is open): the root
    ``serve.call`` holds ``serve.prefill``, ``serve.release`` (the prefill
    step, its graph and slot), ``serve.decode_capture``, one ``serve.token``
    a decode step (the step's call, ``serve.step``, timed on the card too,
    then the host's read of the token) and ``serve.release`` (the decode
    step); on a card the counters ``alloc.device_mallocs`` and
    ``alloc.device_frees`` count the caching allocator's ``cudaMalloc`` and
    ``cudaFree`` calls over the call.

    The prefill goes through ``launch.step.build_prefill_step``, as the
    reference's goes through ``jax.jit`` of its prefill (one layer's CUDA
    graph replayed over the layers on a card), and the decode steps through
    ``launch.step.build_serve_step``, as the reference's go through
    ``jax.jit(build_serve_step(arch))``, with ``cache_len`` a device scalar.
    """
    if keep_logits and record is None:
        raise ValueError("serve: keep_logits keeps them in a record; pass record=")
    arch = get_config(arch_name)
    if reduced:
        arch = dataclasses.replace(arch, model=arch.model.reduce())
    cfg = arch.model
    dev = resolve(device)
    with spans.span("serve.call", arch=arch_name, batch=batch, prompt_len=prompt_len,
                    gen=gen):
        allocs = _device_allocs(dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        if params is None:
            params = init_params(cfg, g, dev)
        elif not same_device(next(params.parameters()).device, dev):
            raise ValueError(f"serve: params are on {next(params.parameters()).device}, "
                             f"the run on {dev}")
        else:  # weights cut in depth serve at their depth
            cfg = dataclasses.replace(cfg, num_layers=len(params.blocks))
        max_seq = prompt_len + gen

        if prompts is not None:
            pre_batch = _prompt_batch(cfg, prompts, batch, prompt_len, dev)
        elif cfg.family == "vlm":
            pre_batch = {"embeds": torch.randn((batch, prompt_len, cfg.d_model),
                                               generator=g, device=dev)}
        else:
            rng = np.random.default_rng(seed)
            shape = ((batch, prompt_len, cfg.num_codebooks) if cfg.family == "audio"
                     else (batch, prompt_len))
            prompt = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
            pre_batch = {"tokens": torch.from_numpy(prompt).to(dev)}

        # prefill over the prompt, then copy the caches into max_seq buffers
        arch = dataclasses.replace(arch, model=cfg)
        prefill_step = build_prefill_step(arch)
        _sync(dev)
        with spans.span("serve.prefill") as prefill:
            next_tokens, caches_prompt = prefill_step(params, pre_batch)
            caches = rehome_caches(cfg, caches_prompt, batch, max_seq, dev)
            del caches_prompt
            _sync(dev)
        kept = [prefill_step.logits] if keep_logits else None
        prefill_capture_ms = prefill_step.capture_ms
        with spans.span("serve.release"):
            del prefill_step  # its graph's memory pool and slot, before the decode

        next_tokens = next_tokens.to(torch.int32)  # (B,) or (B,K)
        generated = [next_tokens.cpu().numpy()]
        if teacher is not None:
            teacher = torch.as_tensor(np.asarray(teacher), dtype=torch.int32).to(dev)
        # the decode step, captured once its caches are final (after the re-homing)
        step = build_serve_step(arch, device=dev)
        cache_len = torch.tensor(prompt_len, dtype=torch.int32, device=dev)
        with spans.span("serve.decode_capture") as capture:
            if gen > 1:
                step.capture(params, {"tokens": next_tokens if teacher is None
                                      else teacher[:, 0]}, caches, cache_len)
                _sync(dev)
        token_spans = []
        for i in range(gen - 1):
            with spans.span("serve.token") as token:
                step_in = next_tokens if teacher is None else teacher[:, i]
                with spans.span("serve.step", device=dev):
                    next_tokens, caches = step(params, {"tokens": step_in}, caches, cache_len)
                if kept is not None:  # a graph rewrites one logits buffer every replay
                    kept.append(step.logits.clone())
                next_tokens = next_tokens.to(torch.int32)
                cache_len += 1
                generated.append(next_tokens.cpu().numpy())
            token_spans.append(token)
        with spans.span("serve.release"):
            del step
        if allocs is not None:
            for name, n in _device_allocs(dev).items():
                spans.count(name, n - allocs[name])
    if record is not None:
        dt = (token_spans[-1].t1 - token_spans[0].t0) / 1e9 if token_spans else 0.0
        record.update(prefill_ms=prefill.ms, prefill_capture_ms=prefill_capture_ms,
                      capture_ms=capture.ms, decode_ms_per_token=dt / max(gen - 1, 1) * 1e3,
                      tokens_per_s=batch * (gen - 1) / dt if dt > 0 else 0.0)
        if keep_logits:
            record["logits"] = kept
    return np.stack(generated, axis=1)


ALLOC_STATS = {"alloc.device_mallocs": "num_device_alloc", "alloc.device_frees": "num_device_free"}


def _device_allocs(dev: torch.device) -> dict | None:
    """The caching allocator's device allocation and free counts so far, by
    counter name, while a recording is open on a card; else None (no
    ``memory_stats`` call)."""
    if spans.active() is None or dev.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(dev)
    return {name: stats[key] for name, key in ALLOC_STATS.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen2-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    rec = {}
    toks = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
                 device=args.device, record=rec)
    ms = rec["decode_ms_per_token"]
    print(f"[{args.arch}] generated {toks.shape} tokens in "
          f"{ms * max(args.gen - 1, 1) / 1e3:.2f}s ({ms:.1f} ms/token) on {resolve(args.device)}")


if __name__ == "__main__":
    main()
