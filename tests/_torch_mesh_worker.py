"""One rank of the (2, 2) gloo mesh that tests/test_torch_mesh_train.py
starts four times: it takes the port's sharded train and decode steps on
the inputs the test wrote (JAX's weights and seeded batches, as NumPy) and
rank 0 writes the whole results back.

    python tests/_torch_mesh_worker.py <rank> <world> <store file> <in dir> <out dir>
"""
import dataclasses
import json
import pickle
import sys
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate


def _unreduced(g, want):
    """The fault: each rank's partial gradient taken as if it were the sum."""
    local = DTensor.from_local(g.to_local(), g.device_mesh,
                               [Replicate() if isinstance(p, Partial) else p for p in g.placements],
                               run_check=False, shape=g.shape, stride=g.stride())
    return local.redistribute(g.device_mesh, want)


def main(rank: int, world: int, store_path: str, indir: str, outdir: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    from repro_torch import configs
    from repro_torch.interop import params_from_jax
    from repro_torch.launch import step as tstep
    from repro_torch.launch.analysis import TraceCounter
    from repro_torch.launch.mesh import make_test_mesh, mesh_context
    from repro_torch.launch.sharding import distribute_module, param_specs
    from repro_torch.models import common
    from repro_torch.models import transformer as tf
    from repro_torch.optim import init_state

    mesh = make_test_mesh((2, 2), device_type="cpu")
    cases = pickle.loads(Path(indir, "cases.pkl").read_bytes())
    out = {}
    for case in cases:
        arch = configs.get_config(case["arch"])
        arch = dataclasses.replace(arch, model=arch.model.reduce(),
                                   train=dataclasses.replace(arch.train, **case["train"]))
        cfg = arch.model
        model = params_from_jax(case["params"], cfg, "cpu")
        res = {}
        if case["kind"] == "train":
            common.set_sharding_mode(case["mode"])
            real = tstep._reduce_grad
            try:
                state = init_state(model, tstep._adamw_cfg(arch, None))
                model, state = tstep.place_train_state(arch, model, state, mesh)
                shape = configs.ShapeConfig("t", case["S"], case["B"], "train")
                fn = tstep.build_train_step(arch, shape, mesh, total_steps=10)
                if case.get("fault"):
                    tstep._reduce_grad = _unreduced
                batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
                counter = TraceCounter()
                with counter:
                    _, state, m = fn(model, state, batch, 5)
            finally:
                tstep._reduce_grad = real
                common.set_sharding_mode("2d")
            res["metrics"] = {k: float(v) for k, v in m.items()}
            res["params"] = {n: p.full_tensor().detach().numpy()
                             for n, p in model.named_parameters()}
            res["collectives"] = counter.collectives().as_dict()
            res["grad_placements"] = sorted({str(p.placements) for p in model.parameters()})
        else:
            distribute_module(model, param_specs(cfg, model), mesh)
            tokens = {"tokens": torch.from_numpy(case["tokens"])}

            def caches():
                return tstep.place_caches(arch, {k: torch.from_numpy(v)
                                                 for k, v in case["caches"].items()}, mesh)

            with mesh_context(mesh):
                logits, new = tf.decode_step(model, tstep.place_batch(arch, tokens, mesh, "decode"),
                                             caches(), case["cache_len"], cfg)
                logits = logits.full_tensor()
            res["logits"] = logits.numpy()
            res["caches"] = {k: v.full_tensor().numpy() for k, v in new.items()}
            res["cache_placements"] = {k: str(v.placements) for k, v in new.items()}
            nxt, _ = tstep.build_serve_step(arch, mesh)(model, tokens, caches(),
                                                        case["cache_len"])
            res["next_tokens"] = nxt.numpy()
        out[case["name"]] = res
    if rank == 0:
        Path(outdir, "out.pkl").write_bytes(pickle.dumps(out))
        Path(outdir, "done.json").write_text(json.dumps(sorted(out)))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
