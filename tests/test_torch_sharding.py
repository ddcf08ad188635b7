"""The port's logical-axis sharding rules (``repro_torch.models.sharding``,
``repro_torch.utils.meshctx``) against the JAX package's.

- Spec-tree parity: for the ten architectures at full width, on the
  16 × 16 and 2 × 16 × 16 meshes, every parameter leaf's sanitized spec and
  local shard shape equal the JAX package's. The port's side runs on a
  ``fake`` 512-rank process group in a subprocess
  (``tests/torch_fake_mesh_worker.py shapes``): DTensor's own local shapes
  of fake parameters. The JAX side is ``model.init`` under
  ``jax.eval_shape`` and ``sanitize_specs`` on a stub mesh (a shard's shape
  is the dim over the product of its axes' sizes). Shapes, not bytes: the
  JAX package's bf16 factors keep f32 bases (ROADMAP.md, queue 3).
- ``_resolve`` under client mode, ``factor_spec``, the dense weight's
  same-axis rule, and ``constrain``'s dropping of dims the mesh does not
  divide, on a 2 × 2 gloo mesh.
- A tuple axis ("pod", "data") splits pod-major, as ``NamedSharding``
  does: on a 2 × 2 × 2 gloo mesh each rank's slice is held to JAX's
  ``devices_indices_map`` on 8 host devices (a subprocess of its own).

Both packages keep their sharding switches in module globals; the fixture
turns both off in a ``finally``.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.sharding as jsharding
from repro.configs import ALIASES as JAX_ALIASES
from repro.configs import get_config as jax_get_config
from repro.launch.specs import sanitize_specs as jax_sanitize_specs
from repro.models import build_model as jax_build_model
from repro_torch.configs import ALIASES
from repro_torch.core.factorization import LowRankFactor
from repro_torch.models import sharding
from repro_torch.models.layers import Builder
from repro_torch.models.config import LowRankPolicy
from repro_torch.utils.meshctx import P
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))


class _JaxStub:
    """What the JAX package's ``sharding.enable`` and ``sanitize_specs``
    read off a mesh."""

    def __init__(self, names, sizes):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


class _TorchStub:
    """What the port's rules read off a ``DeviceMesh``."""

    def __init__(self, names, sizes):
        self.mesh_dim_names = names
        self._sizes = sizes

    def size(self, i=None):
        return int(np.prod(self._sizes)) if i is None else self._sizes[i]


@pytest.fixture
def rules_off():
    try:
        yield
    finally:
        sharding.set_client_mode(False)
        sharding.enable(None)
        jsharding.set_client_mode(False)
        jsharding.enable(None)


MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


@pytest.fixture(scope="module")
def port_shapes(tmp_path_factory):
    out = tmp_path_factory.mktemp("shapes") / "shapes.json"
    p = subprocess.run([sys.executable, os.path.join(ROOT, "tests", "torch_fake_mesh_worker.py"),
                        "shapes", str(out)], capture_output=True, text=True, env=ENV, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


def _jax_local(arch, mesh_name):
    names, sizes = MESHES[mesh_name]
    stub = _JaxStub(names, sizes)
    jsharding.enable(stub)
    try:
        model = jax_build_model(jax_get_config(arch))
        box = {}

        def init(k):
            p, s = model.init(k)
            box["s"] = s
            return p

        shapes = jax.eval_shape(init, jax.ShapeDtypeStruct((2,), jnp.uint32))
        specs = jax_sanitize_specs(stub, shapes, box["s"])
    finally:
        jsharding.enable(None)
    out = {}
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    spec_leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    for (path, leaf), (_, spec) in zip(leaves, spec_leaves):
        local = list(leaf.shape)
        spec = list(spec) + [None] * (len(local) - len(spec))
        for i, ax in enumerate(spec):
            if ax is not None:
                local[i] //= int(np.prod([stub.shape[a] for a in (ax if isinstance(ax, tuple)
                                                                  else (ax,))]))
        out[jax.tree_util.keystr(path)] = (local, [list(a) if isinstance(a, tuple) else a
                                                   for a in spec])
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ALIASES))
def test_local_shard_shapes_match_reference(port_shapes, arch, mesh_name, rules_off):
    assert sorted(ALIASES) == sorted(JAX_ALIASES)
    want = _jax_local(arch, mesh_name)
    got = port_shapes[arch][mesh_name]
    assert sorted(got) == sorted(want)
    for path, (shape, spec) in want.items():
        assert got[path][0] == shape, (path, got[path], shape)
        assert got[path][1] == spec, (path, got[path], spec)


def test_resolve_client_mode_and_factor_spec(rules_off):
    for pkg, stub in ((sharding, _TorchStub(("pod", "data", "model"), (2, 2, 2))),
                      (jsharding, _JaxStub(("pod", "data", "model"), (2, 2, 2)))):
        pkg.enable(stub)
        assert tuple(pkg.spec("batch", "seq", None)) == (("pod", "data"), "model", None)
        assert tuple(pkg.spec("experts", "layers", "rank")) == ("model", None, None)
        pkg.set_client_mode(True)
        assert pkg._resolve("batch") is None and pkg._resolve("clients") is None
        assert pkg._resolve("heads") == "model"
        pkg.set_client_mode(False)
    sharding.enable(_TorchStub(("data", "model"), (2, 2)))
    jsharding.enable(_JaxStub(("data", "model"), (2, 2)))
    assert sharding._resolve("batch") == ("data",) == jsharding._resolve("batch")
    f, jf = sharding.factor_spec(("layers",), "embed", "heads"), jsharding.factor_spec(
        ("layers",), "embed", "heads")
    assert isinstance(f, LowRankFactor)
    for name in ("U", "S", "V", "rank"):
        assert tuple(getattr(f, name)) == tuple(getattr(jf, name)), name
    assert tuple(f.U) == (None, "model", None) and tuple(f.V) == (None, "model", None)


def test_dense_weight_same_axis_keeps_output_dim(rules_off):
    sharding.enable(_TorchStub(("data", "model"), (2, 2)))
    b = Builder(torch.Generator(), LowRankPolicy(enable=False))
    b.linear("w", 8, 16, li="embed", lo="ffn")  # both → model: li dropped
    b.linear("x", 8, 16, li="embed", lo=None)
    b.linear("y", 8, 16, li="heads", lo="embed", bias=True)
    params, specs = b.build()
    assert specs["w"] == P(None, "model")
    assert specs["x"] == P("model", None)
    assert specs["y"] == P(None, "model") and specs["y_b"] == P("model")
    assert params["w"].shape == (8, 16)


_GLOO = r'''
import json, os, sys, torch, torch.distributed as dist, torch.multiprocessing as mp

def run(rank, d):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(d, "s"), 8),
                            rank=rank, world_size=8)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models import sharding
    from repro_torch.utils import meshctx
    from repro_torch.utils.meshctx import P
    mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    sharding.enable(mesh)
    x = distribute_tensor(torch.arange(16.0 * 6).reshape(16, 6), mesh,
                          meshctx.placements(P(("pod", "data"), None), mesh))
    y = meshctx.constrain(x, P(("pod", "data"), "model"))
    z = sharding.shard(y.redistribute(mesh, meshctx.placements(P(), mesh)), None, "heads")
    w = meshctx.constrain(torch.zeros(3), P("model"))  # a plain tensor: itself
    odd = distribute_tensor(torch.zeros(8, 5), mesh, meshctx.placements(P(), mesh))
    odd = meshctx.constrain(odd, P(None, "model"))     # 5 % 2: stays whole
    out = {"rows": x.to_local()[:, 0].tolist(), "coord": mesh.get_coordinate(),
           "y": [str(p) for p in y.placements], "z": [str(p) for p in z.placements],
           "plain": isinstance(w, torch.Tensor) and type(w) is torch.Tensor,
           "odd": [str(p) for p in odd.placements]}
    with open(os.path.join(d, f"{rank}.json"), "w") as f:
        json.dump(out, f)
    sharding.enable(None)
    dist.destroy_process_group()

if __name__ == "__main__":
    mp.spawn(run, args=(sys.argv[1],), nprocs=8)
'''

_JAX = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2), ("pod", "data", "model"))
sh = NamedSharding(mesh, P(("pod", "data"), None))
idx = sh.devices_indices_map((16, 6))
out = {}
for coord in np.ndindex(2, 2, 2):
    dev = mesh.devices[coord]
    out[",".join(map(str, coord))] = [idx[dev][0].start, idx[dev][0].stop]
print(json.dumps(out))
'''


def test_tuple_axis_is_pod_major_and_constrain_drops_odd_dims(tmp_path):
    script = tmp_path / "gloo.py"  # spawned workers re-import their script
    script.write_text(_GLOO)
    p = subprocess.run([sys.executable, str(script), str(tmp_path)], capture_output=True,
                       text=True, env=ENV, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    q = subprocess.run([sys.executable, "-c", _JAX], capture_output=True, text=True,
                       env=dict(ENV, JAX_PLATFORMS="cpu"), timeout=300)
    assert q.returncode == 0, q.stderr[-3000:]
    want = json.loads(q.stdout.strip().splitlines()[-1])
    for rank in range(8):
        with open(tmp_path / f"{rank}.json") as f:
            got = json.load(f)
        start, stop = want[",".join(map(str, got["coord"]))]
        assert got["rows"] == [6.0 * r for r in range(start, stop)], (rank, got)
        assert got["y"] == ["S(0)", "S(0)", "S(1)"], got["y"]
        assert got["z"] == ["R", "R", "S(1)"], got["z"]
        assert got["plain"]
        assert got["odd"] == ["R", "R", "R"]
