"""The port's side of ``tests/test_torch_mesh.py``: four gloo ranks on the
CPU, a 2 × 2 ``("data", "model")`` mesh, one reduced architecture.

    python tests/torch_mesh_worker.py DIR ARCH

reads ``DIR/in.npz`` (the JAX package's parameters, flattened; the token
batches; the config overrides as JSON) and writes ``DIR/out.npz`` from rank
0: the sharded loss, the prefill and greedy-decode logits (of 4 rows, and
of one row: its cache split on the sequence), and a FeDLRT
round with ``spec_tree`` / ``client_axes`` (each factor's ``U S Vᵀ`` and
rank, the round's losses).
"""
import dataclasses
import json
import os
import sys

import numpy as np


def _whole(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def run(rank: int, world: int, d: str, arch: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(d, "store"), world),
                            rank=rank, world_size=world)
    try:
        _work(rank, d, arch)
    finally:
        dist.destroy_process_group()


def _work(rank: int, d: str, arch: str) -> None:
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.checkpoint import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.core import FedConfig
    from repro_torch.core.factorization import is_factor
    from repro_torch.core.fedlrt import fedlrt_round
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model, reduced, sharding
    from repro_torch.utils import meshctx
    from repro_torch.utils.tree import tree_map_with_path

    data = np.load(os.path.join(d, "in.npz"))
    meta = json.loads(bytes(data["__meta__"]).decode())
    flat = {k[2:]: data[k] for k in data.files if k.startswith("p:")}
    cfg = dataclasses.replace(reduced(get_config(arch), **meta["overrides"]), kernels="auto")
    model = build_model(cfg)
    mesh = make_host_mesh(2, 2)
    sharding.enable(mesh)
    try:
        _, specs = model.init(torch.Generator().manual_seed(0))
        params = params_from_numpy(flat, "cpu")
        specs = sharding.sanitize(mesh, params, specs)
        dp = sharding.distribute(params, specs, mesh)

        def rows(x):
            return distribute_tensor(torch.from_numpy(x), mesh,
                                     meshctx.placements(meshctx.P("data", None), mesh))

        out = {}
        with torch.no_grad():
            out["loss"] = _whole(model.loss_fn(dp, {"tokens": rows(data["tokens"])})).numpy()
            logits, cache = model.serve_prefill(dp, {"tokens": rows(data["prompt"])},
                                                cache_len=int(meta["cache_len"]))
            steps = [_whole(logits).numpy()]
            for _ in range(int(meta["steps"])):
                nxt = steps[-1].argmax(-1)[:, None].astype(np.int32)
                logits, cache = model.serve_step(dp, cache, rows(nxt))
                steps.append(_whole(logits).numpy())
            out["logits"] = np.stack(steps)
            # one row: fewer rows than the data axis, so the cache is split
            # on its sequence and attention splits the keys across ranks
            one = {"tokens": torch.from_numpy(data["prompt"][:1])}
            logits, cache = model.serve_prefill(dp, one, cache_len=int(meta["cache_len"]))
            steps = [_whole(logits).numpy()]
            for _ in range(int(meta["steps"])):
                nxt = torch.from_numpy(steps[-1].argmax(-1)[:, None].astype(np.int32))
                logits, cache = model.serve_step(dp, cache, nxt)
                steps.append(_whole(logits).numpy())
        out["logits_row"] = np.stack(steps)

        sharding.set_client_mode(True)
        fc = FedConfig(num_clients=4, s_star=2, lr=1e-2, tau=0.01)
        new, metrics = fedlrt_round(model.loss_fn, dp, {"tokens": torch.from_numpy(data["round"])},
                                    fc, spec_tree=specs, client_axes=("data",))
        for k in ("loss_before", "loss_after"):
            out[k] = _whole(metrics[k]).numpy()

        def factor(path, f):
            if is_factor(f):
                U, S, V = _whole(f.U), _whole(f.S), _whole(f.V)
                out["usv" + path] = (U @ S @ V.transpose(-1, -2)).numpy()
                out["rank" + path] = _whole(f.rank).numpy()
            return f

        tree_map_with_path(factor, new, is_leaf=is_factor)
    finally:
        sharding.set_client_mode(False)
        sharding.enable(None)
    if rank == 0:
        np.savez(os.path.join(d, "out.npz"), **out)


if __name__ == "__main__":
    import torch.multiprocessing as mp

    mp.spawn(run, args=(4, sys.argv[1], sys.argv[2]), nprocs=4)
