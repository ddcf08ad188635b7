"""Port-side checks that need a large mesh, run on a ``fake`` process group
of 512 ranks in their own process (the group is process-wide), for
``tests/test_torch_sharding.py`` and ``tests/test_torch_roofline.py``:

    python tests/torch_fake_mesh_worker.py shapes OUT.json
        every parameter leaf's local shard shape and sanitized spec, for the
        ten architectures at full width, on the 16 × 16 and 2 × 16 × 16
        meshes (fake tensors: nothing is allocated)
    python tests/torch_fake_mesh_worker.py counts OUT.json
        what ``LocalCounter`` counts for known redistributions and products

This process is rank 0 of the group.
"""
import json
import sys

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.testing._internal.distributed.fake_pg import FakeStore


def meshes():
    return {
        "16x16": DeviceMesh("cpu", torch.arange(256).reshape(16, 16),
                            mesh_dim_names=("data", "model")),
        "2x16x16": DeviceMesh("cpu", torch.arange(512).reshape(2, 16, 16),
                              mesh_dim_names=("pod", "data", "model")),
    }


def shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import ALIASES, get_config
    from repro_torch.launch.specs import sanitize_specs
    from repro_torch.models import build_model, sharding
    from repro_torch.utils.meshctx import is_spec
    from repro_torch.utils.tree import tree_map_with_path

    out = {}
    for name, mesh in meshes().items():
        sharding.enable(mesh)
        try:
            for arch in ALIASES:
                with FakeTensorMode():
                    params, specs = build_model(get_config(arch)).init(torch.Generator())
                    specs = sanitize_specs(mesh, params, specs)
                    local = sharding.distribute(params, specs, mesh)
                rec = {}
                tree_map_with_path(lambda p, t: rec.setdefault(p, [list(t.to_local().shape)]),
                                   local)
                tree_map_with_path(lambda p, s: rec[p].append(
                    [list(a) if isinstance(a, tuple) else a for a in s]), specs, is_leaf=is_spec)
                out.setdefault(arch, {})[name] = rec
        finally:
            sharding.enable(None)
    return out


def counts():
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    from repro_torch.launch.roofline import LocalCounter

    m16 = meshes()["16x16"]
    # an 8-wide model axis at stride 1: its groups sit in one node of 8 cards
    m8 = DeviceMesh("cpu", torch.arange(256).reshape(32, 8), mesh_dim_names=("data", "model"))
    out = {}
    counter = LocalCounter()
    with counter:
        for tag, mesh in (("node2", m16), ("node1", m8)):
            x = distribute_tensor(torch.zeros(1024, 512), mesh, [Replicate(), Shard(0)])
            with counter.counting():
                x.redistribute(mesh, [Replicate(), Replicate()])
            out[f"all_gather_{tag}"] = [counter.collectives, counter.collective_seconds]
        p = DTensor.from_local(torch.zeros(1024, 512), m16, [Replicate(), Partial()],
                               run_check=False)
        with counter.counting():
            p.redistribute(m16, [Replicate(), Replicate()])
        out["all_reduce"] = [counter.collectives, counter.collective_seconds]
        with counter.counting():
            p.redistribute(m16, [Replicate(), Shard(0)])
        out["reduce_scatter"] = [counter.collectives, counter.collective_seconds]
        a = distribute_tensor(torch.zeros(4096, 3584), m16, [Replicate(), Shard(1)])
        b = distribute_tensor(torch.zeros(3584, 256), m16, [Replicate(), Shard(0)])
        with counter.counting():
            c = a @ b
        out["matmul"] = [counter.flops, [str(pl) for pl in c.placements],
                         list(c.to_local().shape)]
    return out


if __name__ == "__main__":
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    result = {"shapes": shapes, "counts": counts}[sys.argv[1]]()
    with open(sys.argv[2], "w") as f:
        json.dump(result, f)
