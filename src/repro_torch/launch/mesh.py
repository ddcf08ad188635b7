"""Production mesh construction, the JAX package's ``launch/mesh.py`` on
``torch.distributed``'s ``DeviceMesh``.

The meshes keep the JAX package's shapes and axis names. They are built
on the process group the caller has set up: the ``fake`` group of the dry
run (:mod:`repro_torch.launch.dryrun`), NCCL on cards, gloo in the tests.
The JAX package's ``mesh_kwargs`` (its ``axis_types`` switch for
jax ≥ 0.5) has no counterpart here: a ``DeviceMesh`` has one kind of axis.

Axis semantics:
  pod   — cross-pod data parallelism (federated clients span pods too)
  data  — within-pod data parallelism = the federated-client axis
  model — tensor/expert parallelism within a client's shard
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")``, over a process group of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 2, model: int = 2) -> DeviceMesh:
    """A small ``("data", "model")`` mesh of CPU ranks (a gloo group; the
    tests)."""
    return init_device_mesh("cpu", (data, model), mesh_dim_names=("data", "model"))


def data_axis_size(mesh: DeviceMesh) -> int:
    names = tuple(mesh.mesh_dim_names)
    n = mesh.size(names.index("data"))
    if "pod" in names:
        n *= mesh.size(names.index("pod"))
    return n
