"""The port's side of ``tests/test_torch_mesh.py``: four gloo ranks on the
CPU, a 2 × 2 ``("data", "model")`` mesh, one reduced architecture.

    python tests/torch_mesh_worker.py DIR ARCH

reads ``DIR/in.npz`` (the JAX package's parameters, flattened; the token
batches; the config overrides as JSON) and writes ``DIR/out.npz`` from rank
0: the sharded loss, the prefill and greedy-decode logits (of 4 rows, and
of one row: its cache split on the sequence), and a FeDLRT
round with ``spec_tree`` / ``client_axes`` (each factor's ``U S Vᵀ`` and
rank, the round's losses). Where the meta names ``wire_codecs``, the same
round again under each codec on the mesh (its losses, factors and measured
bytes, and whether it is bit-identical to the round without a wire), and
the port's unsharded round under each (its measured bytes, losses and
factors).
"""
import dataclasses
import json
import os
import sys

import numpy as np


#: the measured bytes of a round under a wire
BYTES = ("wire_bytes_down_per_client", "wire_bytes_up_per_client")


def _whole(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _record(out: dict, prefix: str, new, metrics) -> None:
    """A round's losses, measured bytes (under a wire) and each factor's
    ``U S Vᵀ`` and rank, whole, into ``out`` under ``prefix``."""
    from repro_torch.core.factorization import is_factor
    from repro_torch.utils.tree import tree_map_with_path

    for k in ("loss_before", "loss_after") + tuple(k for k in BYTES if k in metrics):
        out[prefix + k] = np.asarray(_whole(metrics[k]))

    def factor(path, f):
        if is_factor(f):
            U, S, V = _whole(f.U), _whole(f.S), _whole(f.V)
            out[prefix + "usv" + path] = (U @ S @ V.transpose(-1, -2)).numpy()
            out[prefix + "rank" + path] = _whole(f.rank).numpy()
        return f

    tree_map_with_path(factor, new, is_leaf=is_factor)


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
    from repro_torch.core.fedlrt import fedlrt_round
    from repro_torch.fed.wire import Wire
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model, reduced, sharding
    from repro_torch.utils import meshctx
    from repro_torch.utils.tree import tree_leaves

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
        batch = {"tokens": torch.from_numpy(data["round"])}
        new, metrics = fedlrt_round(model.loss_fn, dp, batch, fc, spec_tree=specs,
                                    client_axes=("data",))
        _record(out, "", new, metrics)

        def same_bits(a, b):
            la, lb = tree_leaves(a), tree_leaves(b)
            return len(la) == len(lb) and all(
                torch.equal(_local(x), _local(y)) for x, y in zip(la, lb) if torch.is_tensor(x))

        for codec in meta.get("wire_codecs", ()):
            wnew, wm = fedlrt_round(model.loss_fn, dp, batch, fc, spec_tree=specs,
                                    client_axes=("data",), wire=Wire(codec))
            out[codec + ":same_bits"] = np.asarray(
                same_bits(new, wnew) and all(torch.equal(_local(metrics[k]), _local(wm[k]))
                                             for k in ("loss_before", "loss_after")))
            _record(out, codec + ":", wnew, wm)
    finally:
        sharding.set_client_mode(False)
        sharding.enable(None)
    for codec in meta.get("wire_codecs", ()):  # the port without a mesh
        _record(out, codec + ":unsharded:", *fedlrt_round(model.loss_fn, params, batch, fc,
                                                         wire=Wire(codec)))
    if rank == 0:
        np.savez(os.path.join(d, "out.npz"), **out)


if __name__ == "__main__":
    import torch.multiprocessing as mp

    mp.spawn(run, args=(4, sys.argv[1], sys.argv[2]), nprocs=4)
