"""Logical-axis sharding rules, the JAX package's ``models/sharding.py`` on
DTensor.

Model code tags every parameter and key activation with *logical* axis
names; this module maps them to mesh axes:

    batch   → ("pod", "data")   — the federated-client axis
    heads / ffn / experts / vocab / mamba_inner → "model"  (tensor/expert
                                                             parallelism)
    everything else → replicated

The mapping applies only while :data:`ENABLED` is on (a launcher turns it
on with a mesh; the CPU unit tests run with it off and need no process
group). :func:`shard` is likewise a no-op without it.

For a factorized weight ``W = U S Vᵀ`` the *bases* carry the tensor-parallel
sharding of the corresponding dense dimension (U on n_in's axis, V on
n_out's axis) while the small ``S`` and the rank scalar stay replicated,
so a tensor-parallel partial sum ``(x U_local) S`` is reduced at width
``r`` instead of the dense width (:mod:`repro_torch.kernels.ops`).

A spec tree mirrors a parameter tree with :class:`~repro_torch.utils.meshctx.P`
leaves (a factor's spec is a ``LowRankFactor`` of four). :func:`tree_shardings`
turns it into DTensor placements and :func:`distribute` lays a parameter
tree out by it.
"""
from __future__ import annotations

from typing import Optional, Tuple

from torch.distributed.tensor import distribute_tensor

from repro_torch.core.factorization import LowRankFactor
from repro_torch.utils import meshctx
from repro_torch.utils.meshctx import P
from repro_torch.utils.tree import tree_map, tree_map_with_path

ENABLED = False

# logical axis name → mesh axis (None = replicated)
RULES = {
    "batch": ("pod", "data"),
    "clients": ("pod", "data"),
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "experts": "model",
    "vocab": "model",
    # FSDP-style factor sharding: low-rank bases are cheap to all-gather
    # (O(n·r), not O(n²)), so the d_model-sized dim of U/V shards too
    "embed": "model",
    "mamba_inner": "model",
    "rwkv_heads": "model",
    # sequence parallelism: the residual stream's T dim lives on the model
    # axis between blocks; decode (T = 1) falls back to replicated through
    # the divisibility check of shard()
    "seq": "model",
    "layers": None,
    "rank": None,
}

_ACTIVE_MESH_AXES: Tuple[str, ...] = ()
_CLIENT_MODE = False


def enable(mesh):
    """Turn on sharding annotations for ``mesh`` (``None`` turns them off)."""
    global ENABLED, _ACTIVE_MESH_AXES
    meshctx.enable(mesh)
    if mesh is None:
        ENABLED = False
        _ACTIVE_MESH_AXES = ()
    else:
        ENABLED = True
        _ACTIVE_MESH_AXES = tuple(mesh.mesh_dim_names)


def set_client_mode(on: bool):
    """Inside a FeDLRT round whose client axis lives on the data axes, the
    in-model "batch" constraints must not name those axes: each rank runs
    its own clients, and a client's batch is local to it."""
    global _CLIENT_MODE
    _CLIENT_MODE = on


def _resolve(logical: Optional[str]):
    if logical is None:
        return None
    if _CLIENT_MODE and logical in ("batch", "clients"):
        return None
    mesh_axis = RULES.get(logical)
    if mesh_axis is None:
        return None
    if isinstance(mesh_axis, tuple):
        avail = tuple(a for a in mesh_axis if a in _ACTIVE_MESH_AXES)
        return avail if avail else None
    return mesh_axis if mesh_axis in _ACTIVE_MESH_AXES else None


def spec(*logical_axes) -> P:
    """The spec of a tensor whose dims carry these logical names."""
    return P(*[_resolve(a) for a in logical_axes])


def shard(x, *logical_axes):
    """Activation sharding constraint (returns ``x`` unless ENABLED). Dims
    the mesh does not divide evenly stay unsharded (e.g. 28 heads on a
    16-wide model axis)."""
    if not ENABLED:
        return x
    return meshctx.constrain(x, P(*[_resolve(a) for a in logical_axes]))


def factor_spec(batch_axes: Tuple[Optional[str], ...], li: Optional[str], lo: Optional[str]):
    """The spec tree of a LowRankFactor with logical dims (li → lo)."""
    return LowRankFactor(
        U=spec(*batch_axes, li, "rank"),
        S=spec(*batch_axes, "rank", "rank"),
        V=spec(*batch_axes, lo, "rank"),
        rank=spec(*batch_axes),
    )


def tree_shardings(mesh, spec_tree):
    """A spec tree as DTensor placements on ``mesh`` (a tuple per leaf)."""
    return tree_map(lambda s: meshctx.placements(s, mesh), spec_tree, is_leaf=meshctx.is_spec)


def sanitize(mesh, params, spec_tree):
    """``spec_tree`` with the dims ``mesh`` does not divide left unsharded
    (the shapes are read off ``params``)."""
    return tree_map(lambda s, t: meshctx.fit(s, t.shape, mesh), spec_tree, params,
                    is_leaf=meshctx.is_spec)


def distribute(params, spec_tree, mesh):
    """Lay ``params`` out on ``mesh`` by ``spec_tree`` (sanitized first):
    every tensor leaf becomes a DTensor holding its shard."""
    specs = sanitize(mesh, params, spec_tree)
    return tree_map(
        lambda t, s: distribute_tensor(t, mesh, meshctx.placements(s, mesh)),
        params, specs, is_leaf=None,
    )


def batch_axes(mesh) -> tuple:
    """The mesh axes a batch (or the client cohort) is split over."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def cache_spec(name: str, shape, mesh, shard_seq: bool) -> P:
    """The spec of one decode-cache leaf, by its key path ``name`` (as
    ``tree_map_with_path`` writes it), as the JAX package's
    ``launch/specs.py:cache_specs`` lays it out: the batch on the data axes
    (or, when the batch is smaller than them, ``shard_seq``, the cache's
    sequence dim), heads on "model" where they divide it, else the head
    dim; the recurrent states by their channels. Only dims the mesh divides
    are sharded."""
    bax = batch_axes(mesh)
    dsize = meshctx.axis_size(bax, mesh)
    msize = meshctx.axis_size("model", mesh)

    def fit(dim: int, axis):
        if axis is None:
            return None
        n = dsize if axis == bax else msize
        return axis if dim % n == 0 else None

    nd = len(shape)
    b = None if shard_seq else bax
    if "'k'" in name or "'v'" in name:  # (NB, B, S, Hkv, hd)
        kv_ax = fit(shape[3], "model")
        hd_ax = fit(shape[4], "model") if kv_ax is None else None
        return P(None, fit(shape[1], b), bax if shard_seq else None, kv_ax, hd_ax)
    if "'S'" in name:  # rwkv state (NB, B, H, hd, hd)
        return P(None, fit(shape[1], b), fit(shape[2], "model"), None, None)
    if "'h'" in name and nd == 4:  # mamba (NB, B, d_inner, N)
        return P(None, fit(shape[1], b), fit(shape[2], "model"), None)
    if "'conv'" in name:  # (NB, B, K-1, d_inner)
        return P(None, fit(shape[1], b), None, fit(shape[3], "model"))
    if "'shift'" in name:  # (NB, B, 1, d)
        return P(None, fit(shape[1], b), None, None)
    if "enc_h" in name:  # (B, F, d)
        return P(fit(shape[0], b), None, None)
    return P()  # write indices and positions


def cache_spec_tree(cache, batch: int, mesh):
    """The spec tree of a decode cache of ``batch`` rows on ``mesh``."""
    from repro_torch.launch.mesh import data_axis_size

    shard_seq = batch < data_axis_size(mesh)
    return tree_map_with_path(lambda path, t: cache_spec(path, t.shape, mesh, shard_seq), cache)


def distribute_cache(cache, batch: int, mesh):
    """A fresh (zero) cache laid out on ``mesh`` by :func:`cache_spec_tree`;
    each rank slices its shard, nothing is sent."""
    specs = cache_spec_tree(cache, batch, mesh)
    return tree_map(
        lambda t, s: distribute_tensor(t, mesh, meshctx.placements(s, mesh), src_data_rank=None),
        cache, specs,
    )
