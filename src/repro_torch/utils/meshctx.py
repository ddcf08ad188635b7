"""Process-global device mesh for sharding annotations, the JAX package's
``utils/meshctx.py`` on PyTorch's ``DeviceMesh`` and ``DTensor``.

It lives in ``utils`` so that ``core`` can constrain tensors inside a
FeDLRT round (the augmented bases) without a core → models import cycle.
No mesh is set unless a launcher calls :func:`enable`: then every function
here returns its input and dispatches nothing.

A spec is a :class:`P`: one entry per tensor dimension, each a mesh-axis
name, a tuple of names, or ``None`` (the JAX ``PartitionSpec``). DTensor
indexes its placements by *mesh* dimension instead: :func:`placements`
turns a spec into them. A dimension on the tuple axis ``("pod", "data")``
is ``Shard(d)`` on both mesh dimensions; DTensor splits in mesh order, so
rank ``(p, d)`` holds chunk ``p · |data| + d``, the pod-major order of the
JAX ``NamedSharding``.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication as _implicit_replication

_MESH = None


class P:
    """A partition spec: per tensor dimension a mesh-axis name, a tuple of
    names or ``None``. Unlike a tuple it is a leaf of the port's trees."""

    __slots__ = ("axes",)

    def __init__(self, *axes):
        self.axes = tuple(axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self):
        return len(self.axes)

    def __getitem__(self, i):
        return self.axes[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.axes == other.axes

    def __hash__(self):
        return hash(("P", self.axes))

    def __repr__(self):
        return f"P{self.axes!r}"


def is_spec(x) -> bool:
    return isinstance(x, P)


def enable(mesh):
    """Set (or, with ``None``, clear) the process-global mesh."""
    global _MESH
    _MESH = mesh


def mesh():
    return _MESH


def axis_names(m=None):
    m = m if m is not None else _MESH
    return tuple(m.mesh_dim_names) if m is not None else ()


def axis_size(name, m=None) -> int:
    m = m if m is not None else _MESH
    if m is None:
        return 1
    if isinstance(name, tuple):
        n = 1
        for a in name:
            n *= m.size(m.mesh_dim_names.index(a))
        return n
    return m.size(m.mesh_dim_names.index(name))


def fit(spec, shape, m=None) -> P:
    """``spec`` with every entry the mesh does not divide evenly dropped
    (and padded with ``None`` to ``len(shape)``)."""
    out = []
    for i, n in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        out.append(ax if ax is not None and n % axis_size(ax, m) == 0 else None)
    return P(*out)


def placements(spec, m=None) -> tuple:
    """The DTensor placements (one per mesh dimension) of ``spec`` on ``m``;
    an axis ``m`` lacks is left out (a FeDLRT client runs on the sub-mesh
    without the client axes, where its batch is whole)."""
    m = m if m is not None else _MESH
    names = tuple(m.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a in names:
                out[names.index(a)] = Shard(dim)
    return tuple(out)


def constrain(x, spec):
    """Redistribute the DTensor ``x`` to the placements ``spec`` names,
    leaving unsharded the dimensions the mesh does not divide evenly (DTensor
    would shard them unevenly, and the per-device sizes would then stop
    matching the JAX package's). Without a mesh, or on a plain tensor,
    returns ``x``."""
    if _MESH is None or not isinstance(x, DTensor):
        return x
    want = placements(fit(spec, x.shape), x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


@contextlib.contextmanager
def implicit_replication():
    """DTensor's ``implicit_replication`` (plain tensors taken as whole on
    every rank), re-entrant: an inner block (the model's entry points)
    leaves the flag on for the outer one (the round, whose backward passes
    run after the model has returned)."""
    if DTensor._op_dispatcher._allow_implicit_replication:
        yield
        return
    with _implicit_replication():
        yield


def as_dtensor(t, m):
    """``t`` as a DTensor on mesh ``m``: a plain tensor becomes one that
    every rank holds whole (``Replicate``); a DTensor comes back as it is."""
    if isinstance(t, DTensor) or not torch.is_tensor(t):
        return t
    return DTensor.from_local(t, m, [Replicate()] * m.ndim, run_check=False)


def replicated_local(fn, *tensors):
    """``fn`` on whole copies of DTensor operands, for the ops DTensor has no
    sharding rule for (the round's Cholesky and SVD of ``r × r`` and
    ``2r × 2r`` matrices). Every operand is made ``Replicate`` first; the
    outputs (a tensor or a tuple of tensors) come back as replicated
    DTensors. Without DTensor operands it is ``fn(*tensors)``."""
    dts = [t for t in tensors if isinstance(t, DTensor)]
    if not dts:
        return fn(*tensors)
    m = dts[0].device_mesh
    rep = [Replicate()] * m.ndim
    local = [
        t.redistribute(m, rep).to_local() if isinstance(t, DTensor) else t for t in tensors
    ]
    out = fn(*local)

    def wrap(o):
        return DTensor.from_local(o, m, rep, run_check=False) if torch.is_tensor(o) else o

    return tuple(wrap(o) for o in out) if isinstance(out, tuple) else wrap(out)


def mesh_coordinate(m, name) -> int:
    """This rank's index along the mesh axis (or pod-major tuple of axes)
    ``name``."""
    names = name if isinstance(name, tuple) else (name,)
    idx = 0
    for a in names:
        idx = idx * axis_size(a, m) + m.get_local_rank(a)
    return idx
