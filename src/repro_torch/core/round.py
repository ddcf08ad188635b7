"""Round programs: the shared skeleton of every federated aggregation round
(the JAX package's ``repro.core.round``, in PyTorch).

The paper's Algorithms 1–6 (FeDLRT full/simplified, FedAvg, FedLin, naive
per-client low-rank) all run the same four phases::

    broadcast   server-side prep at the shared point: global gradients,
                basis augmentation, per-client correction terms
    client_step one client's local work, run for each client of the cohort
    aggregate   server reduction over the cohort (weighted mean)
    finalize    truncation / metric assembly on the aggregated state

:func:`run_round` executes any :class:`RoundProgram` through that skeleton.
Where the JAX package ``vmap``s a phase over a leading client axis, the
port loops over the clients in cohort order (``RoundContext.vmap_c``) and
keeps the per-client results as a :class:`~repro_torch.utils.tree.Cohort`,
one tree per client. Every aggregate is a weighted sum taken in that same
order, so one card gives the same bits on every run.

Under a mesh (``spec_tree`` / ``client_axes``: the cohort's client axis
on the mesh's data axes, as the JAX package's ``vmap(spmd_axis_name=…)``
puts it) each rank runs the clients of its own slice of the cohort, and
every aggregate is a weighted sum over the rank's clients all-reduced over
the client axes (:func:`make_context`). The rank's client trees are
DTensors laid out like the parameters. Without a mesh nothing of this
runs.

Gradients come from :func:`value_and_grad`: ``torch.autograd.grad`` over
the floating tensor leaves of a parameter tree, a factor's ``U``, ``S``
and ``V`` among them and never its ``rank``.

The phase boundaries are the round's data plane: what ``broadcast`` hands
the clients crosses the wire down, what ``client_step`` returns crosses up.
:func:`run_round` optionally threads those payloads through a
:class:`repro_torch.fed.wire.Wire` (owned by the engine): encode / decode
plus measured bytes, with server-local state kept out of the transmission
by the ``shared[SERVER]`` convention.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Protocol, runtime_checkable

# repro-lint: disable=RPL004 -- client weights arrive from the engine as
# host numpy arrays and are normalized on the host; no tensor is read back
import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.core.factorization import is_factor
from repro_torch.optim import make_optimizer
from repro_torch.utils import meshctx
from repro_torch.utils.tree import (
    Cohort,
    cohort_size,
    cohort_slice,
    tree_leaves,
    tree_map,
    tree_mean_leading_axis,
)

LossFn = Callable[[Any, Any], torch.Tensor]  # (params, batch) -> scalar


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Hyperparameters of one federated optimization run.

    ``num_clients`` is the size of the *active cohort* a round function
    sees; with partial participation the engine rebuilds the config per
    cohort size.
    """

    num_clients: int
    s_star: int  # local iterations per round
    lr: float = 1e-3
    correction: str = "simplified"  # "none" | "simplified" | "full"
    tau: float = 0.01  # relative singular-value truncation threshold
    optimizer: str = "sgd"
    momentum: float = 0.0
    per_step_batches: bool = False  # batch leaves have a (C, s*, ...) layout
    eval_after: bool = True  # compute the global loss after the round (extra fwd)
    track_drift: bool = False  # record max_s ‖S̃_c^s − S̃‖ (Theorem-1 diagnostics)
    # replicate the augmented bases for the client loop under a mesh (the
    # JAX package's switch; off by default, as there)
    replicate_augmented: bool = False

    def __post_init__(self):
        if self.correction not in ("none", "simplified", "full"):
            raise ValueError(
                f"correction must be 'none', 'simplified' or 'full', "
                f"got {self.correction!r}"
            )
        if self.num_clients <= 0:
            raise ValueError(
                f"num_clients must be a positive cohort size, got {self.num_clients}"
            )
        if self.s_star <= 0:
            raise ValueError(
                f"s_star (local iterations per round) must be positive, "
                f"got {self.s_star}"
            )
        if self.lr <= 0:
            raise ValueError(f"lr must be positive, got {self.lr}")
        if not 0.0 <= self.tau < 1.0:
            raise ValueError(
                f"tau is a *relative* singular-value threshold and must lie "
                f"in [0, 1), got {self.tau}"
            )


def vmap_c(fn: Callable, in_axes=0) -> Callable:
    """The client "vmap": run ``fn`` once per client, in cohort order.

    ``in_axes`` is ``0`` (every argument is per-client) or a tuple with
    ``0`` for a per-client argument (a :class:`Cohort`, or a tree whose
    leaves lead with the client axis, as batches do) and ``None`` for one
    every client shares. Returns the results as a :class:`Cohort`.
    """

    def run(*args):
        axes = (0,) * len(args) if in_axes == 0 else tuple(in_axes)
        sliced = [a for a, ax in zip(args, axes) if ax == 0]
        C = cohort_size(sliced[0])
        return Cohort(
            fn(*(cohort_slice(a, c) if ax == 0 else a for a, ax in zip(args, axes)))
            for c in range(C)
        )

    return run


@dataclasses.dataclass(frozen=True)
class RoundContext:
    """Everything a phase needs beyond its own trees: ``aggregate`` reduces
    a :class:`Cohort` to the server value (plain or ``client_weights``-
    weighted mean), ``vmap_c`` runs a function per client."""

    cfg: FedConfig
    round_idx: int
    aggregate: Callable[[Cohort], Any]
    vmap_c: Callable = vmap_c
    client_weights: Optional[np.ndarray] = None
    spec_tree: Any = None
    client_axes: Any = None
    #: under a mesh: the max over the cohort of a per-client scalar
    reduce_max: Optional[Callable[[Cohort], Any]] = None
    #: under a mesh: a count the rank measured over its own clients, summed
    #: over the client axes (the wire's bytes of the per-client payloads)
    sum_clients: Optional[Callable[[Any], Any]] = None


#: key under which ``broadcast`` stashes server-local state. Everything else
#: in the shared dict is downlink payload, sent to every client.
#: ``client_step`` never sees the server entry; ``aggregate``/``finalize``
#: get the full shared dict.
SERVER = "__server__"

#: canonical phase names of a federated round, in execution order
PHASES = ("broadcast", "client_step", "aggregate", "finalize")


def split_server(shared):
    """Split a broadcast ``shared`` dict into ``(downlink, server_state)``."""
    if isinstance(shared, dict) and SERVER in shared:
        return {k: v for k, v in shared.items() if k != SERVER}, shared[SERVER]
    return shared, None


@runtime_checkable
class RoundProgram(Protocol):
    """One federated algorithm, decomposed into the four round phases."""

    def broadcast(self, loss_fn: LossFn, params, client_batches, ctx: RoundContext):
        """Server-side prep. Returns ``(shared, per_client)``: ``shared`` is
        sent to every client (server-only values under ``shared[SERVER]``),
        ``per_client`` is a :class:`Cohort` (or None)."""
        ...

    def client_step(self, loss_fn: LossFn, shared, per_client, batches, ctx: RoundContext):
        """One client's local work (``shared`` without its SERVER entry)."""
        ...

    def aggregate(self, shared, client_out, ctx: RoundContext):
        """Server reduction over the cohort's client outputs."""
        ...

    def finalize(self, loss_fn: LossFn, params, shared, agg, client_batches, ctx: RoundContext):
        """Post-aggregation server work. Returns ``(new_params, metrics)``."""
        ...


def make_aggregator(client_weights) -> Callable[[Cohort], Any]:
    """Cohort reduction: plain mean, or the normalized ``w``-weighted sum
    (the paper's §2 non-uniform |X_c| extension), taken in f32 in cohort
    order and cast back to each leaf's dtype."""
    if client_weights is None:
        return tree_mean_leading_axis
    w = np.asarray(client_weights, np.float32)
    w = w / np.sum(w, dtype=np.float32)

    def aggregate(cohort: Cohort):
        if len(cohort) != len(w):
            raise ValueError(f"{len(cohort)} client results for {len(w)} weights")

        def wsum(*xs):
            total = float(w[0]) * xs[0].float()
            for wc, x in zip(w[1:], xs[1:]):
                total = total + float(wc) * x.float()
            return total.to(xs[0].dtype)

        return tree_map(wsum, cohort[0], *cohort[1:])

    return aggregate


def make_context(cfg: FedConfig, *, round_idx: int = 0, client_weights=None,
                 spec_tree=None, client_axes=None) -> RoundContext:
    """The round's context. With ``client_axes`` (under a mesh) the client
    "vmap" runs this rank's slice of the cohort and the aggregates reduce
    over the client axes (:func:`_mesh_context`)."""
    if client_axes:
        return _mesh_context(cfg, round_idx, client_weights, spec_tree, tuple(client_axes))
    return RoundContext(
        cfg=cfg,
        round_idx=int(round_idx),
        aggregate=make_aggregator(client_weights),
        client_weights=client_weights,
        spec_tree=spec_tree,
    )


def _mesh_context(cfg, round_idx, client_weights, spec_tree, client_axes) -> RoundContext:
    """Rank-local clients: rank ``k`` along the (pod-major) client axes runs
    clients ``[k·C/n, (k+1)·C/n)``.

    A client's work runs on the sub-mesh of the other axes (the rank's model
    group), where its batch is whole on every rank: there no operation can
    split a tensor over the client axes, so no collective mixes two
    clients. Its results come back to the whole mesh as rank-local values,
    whole on the client axes, and meet other clients' only in an aggregate:
    the rank's clients summed in cohort order, weighted, then all-reduced
    over the client axes, divided by the cohort's size (a weighted one
    sums each client's share; a max all-reduces likewise). On one rank that
    is the plain mean's arithmetic, bit for bit."""
    mesh = meshctx.mesh()
    if mesh is None:
        raise ValueError("client_axes needs a mesh (sharding.enable)")
    C = cfg.num_clients
    n = meshctx.axis_size(client_axes, mesh)
    if C % n:
        raise ValueError(f"{C} clients do not split over {n} ranks of the client axes "
                         f"{client_axes}")
    lo = meshctx.mesh_coordinate(mesh, client_axes) * (C // n)
    if client_weights is not None:
        w = np.asarray(client_weights, np.float32)
        w = w / np.sum(w, dtype=np.float32)
    dims = [mesh.mesh_dim_names.index(a) for a in client_axes]
    group = mesh[tuple(a for a in mesh.mesh_dim_names if a not in client_axes)]

    def to_group(x):
        if not isinstance(x, DTensor) or x.device_mesh.ndim != mesh.ndim:
            return x  # not on the whole mesh: a client's value already
        if any(not isinstance(x.placements[i], Replicate) for i in dims):
            raise ValueError(f"a client's operand is split over the client axes: {x.placements}")
        pl = [p for i, p in enumerate(x.placements) if i not in dims]
        return DTensor.from_local(x.to_local(), group, pl, run_check=False,
                                  shape=x.shape, stride=x.stride())

    def to_mesh(x):
        if not isinstance(x, DTensor) or x.device_mesh.ndim == mesh.ndim:
            return x
        pl = iter(x.placements)
        full = [Replicate() if i in dims else next(pl) for i in range(mesh.ndim)]
        return DTensor.from_local(x.to_local(), mesh, full, run_check=False,
                                  shape=x.shape, stride=x.stride())

    def client_slice(tree, c):
        def one(x):
            if isinstance(x, DTensor):
                x = x.to_local()[c]
            elif torch.is_tensor(x):
                x = x[lo + c]
            else:
                return x
            return DTensor.from_local(x, group, [Replicate()] * group.ndim, run_check=False)

        if isinstance(tree, Cohort):
            return tree_map(to_group, tree[c])
        return tree_map(one, tree)

    def vmap(fn: Callable, in_axes=0) -> Callable:
        def run(*args):
            axes = (0,) * len(args) if in_axes == 0 else tuple(in_axes)
            return Cohort(
                tree_map(to_mesh, fn(*(
                    client_slice(a, c) if ax == 0 and a is not None else tree_map(to_group, a)
                    for a, ax in zip(args, axes))))
                for c in range(C // n)
            )
        return run

    def across(total, op):
        total = meshctx.as_dtensor(total, mesh)
        pl = list(total.placements)
        src = [Partial(op) if i in dims else p for i, p in enumerate(pl)]
        dst = [Replicate() if i in dims else p for i, p in enumerate(pl)]
        part = DTensor.from_local(total.to_local(), mesh, src, run_check=False,
                                  shape=total.shape, stride=total.stride())
        return part.redistribute(mesh, dst)

    def aggregate(cohort: Cohort):
        if client_weights is None:  # the plain mean's order: sum, then divide
            def mean(*xs):
                total = xs[0]
                for x in xs[1:]:
                    total = total + x
                return across(total, "sum") / C

            return tree_map(mean, cohort[0], *cohort[1:])

        def wsum(*xs):
            total = float(w[lo]) * xs[0].float()
            for k, x in enumerate(xs[1:], 1):
                total = total + float(w[lo + k]) * x.float()
            return across(total, "sum").to(xs[0].dtype)

        return tree_map(wsum, cohort[0], *cohort[1:])

    def reduce_max(cohort: Cohort):
        return across(torch.max(torch.stack([meshctx.as_dtensor(x, mesh) for x in cohort])), "max")

    def sum_clients(count):
        """A python int summed exactly (in int64); a ``numpy.float32`` (the
        ``topk_rank`` bytes, which follow each client's ranks) in f32."""
        wide = isinstance(count, np.floating)
        t = torch.tensor(count, dtype=torch.float32 if wide else torch.int64,
                         device=mesh.device_type)
        # repro-lint: disable=RPL004 -- the wire's byte counts are host
        # numbers in the round's metrics: one read a payload, after the round
        total = across(t, "sum").to_local().item()
        return np.float32(total) if wide else int(total)

    return RoundContext(cfg=cfg, round_idx=int(round_idx), aggregate=aggregate, vmap_c=vmap,
                        client_weights=client_weights, spec_tree=spec_tree,
                        client_axes=client_axes, reduce_max=reduce_max,
                        sum_clients=sum_clients)


def run_client_phases(program: RoundProgram, loss_fn: LossFn, params, client_batches,
                      ctx: RoundContext, *, wire=None):
    """The data-plane half of a round: ``broadcast``, then ``client_step``
    for each client, with every boundary payload threaded through ``wire``.

    Returns ``(shared, client_out, (bytes_shared, bytes_per_client,
    bytes_up))``: the server-side broadcast dict (SERVER entry intact), the
    cohort's outputs *as received over the wire*, and the measured byte
    totals per payload (0 without a wire).
    """
    shared, per_client = program.broadcast(loss_fn, params, client_batches, ctx)
    # clients only ever see the downlink part; the server keeps `shared`
    client_shared, _ = split_server(shared)
    bytes_shared = bytes_pc = bytes_up = 0
    if wire is not None:
        client_shared, bytes_shared = wire.roundtrip(client_shared, name="broadcast")
        per_client, bytes_pc = wire.roundtrip(per_client, name="per_client", batched=True)
    client_out = ctx.vmap_c(
        lambda cs, pc, b: program.client_step(loss_fn, cs, pc, b, ctx),
        in_axes=(None, None if per_client is None else 0, 0),
    )(client_shared, per_client, client_batches)
    if wire is not None:
        client_out, bytes_up = wire.roundtrip(client_out, name="client_out", batched=True)
    return shared, client_out, (bytes_shared, bytes_pc, bytes_up)


def run_round(program: RoundProgram, loss_fn: LossFn, params, client_batches, cfg: FedConfig,
              *, round_idx: int = 0, client_weights=None, wire=None, spec_tree=None,
              client_axes=None):
    """Execute one round of ``program``. Returns ``(new_params, metrics)``.

    ``wire`` (optional :class:`repro_torch.fed.wire.Wire`) decorates the
    phase boundaries: the broadcast downlink and per-client slices are
    encoded and decoded before ``client_step`` sees them, the client outputs
    before ``aggregate`` sees them. Measured bytes land in the metrics as
    ``wire_bytes_down_per_client`` (the shared broadcast once per client
    plus that client's slice) and ``wire_bytes_up_per_client``. With the
    identity codec the round is bit-identical to ``wire=None``.

    ``spec_tree`` (the parameters' specs) keeps the augmented and truncated
    factors on their layout under a mesh; ``client_axes`` names the mesh
    axes of the client dim (see :func:`make_context`). Under a mesh the
    codecs see each tensor whole (DTensor reductions: int8's range, the
    ranks), and each rank measures the per-client payloads of its own
    clients, summed over the client axes before the per-client bytes.
    """
    if spec_tree is not None or client_axes:
        with meshctx.implicit_replication():
            return _run_round(program, loss_fn, params, client_batches, cfg, round_idx,
                              client_weights, wire, spec_tree, client_axes)
    return _run_round(program, loss_fn, params, client_batches, cfg, round_idx,
                      client_weights, wire, None, None)


def _run_round(program, loss_fn, params, client_batches, cfg, round_idx, client_weights, wire,
               spec_tree, client_axes):
    ctx = make_context(cfg, round_idx=round_idx, client_weights=client_weights,
                       spec_tree=spec_tree, client_axes=client_axes)
    shared, client_out, (bytes_shared, bytes_pc, bytes_up) = run_client_phases(
        program, loss_fn, params, client_batches, ctx, wire=wire
    )
    agg = program.aggregate(shared, client_out, ctx)
    new_params, metrics = program.finalize(loss_fn, params, shared, agg, client_batches, ctx)
    if wire is not None:
        if ctx.sum_clients is not None:  # each rank measured its own clients
            bytes_pc, bytes_up = ctx.sum_clients(bytes_pc), ctx.sum_clients(bytes_up)
        metrics = dict(metrics)
        metrics["wire_bytes_down_per_client"] = _per_client_bytes(
            bytes_shared, bytes_pc, cfg.num_clients
        )
        metrics["wire_bytes_up_per_client"] = _per_client_bytes(0, bytes_up, cfg.num_clients)
    return new_params, metrics


def _per_client_bytes(shared_bytes, batched_bytes, num_clients: int):
    """``shared + batched/C`` per-client bytes, exactly when possible: python
    int counts whose batched total divides evenly over the C equal client
    slices stay integers (so measured == analytic holds exactly); the
    rank-dependent ``topk_rank`` counts take the f32 path, as in the JAX
    package."""
    if (
        isinstance(shared_bytes, int)
        and isinstance(batched_bytes, int)
        and batched_bytes % num_clients == 0
    ):
        return shared_bytes + batched_bytes // num_clients
    return np.float32(shared_bytes) + np.float32(batched_bytes) / np.float32(num_clients)


# ---------------------------------------------------------------------------
# gradients over parameter trees
# ---------------------------------------------------------------------------


def _leaf(t) -> bool:
    return torch.is_tensor(t) and t.is_floating_point()


def value_and_grad(fn: Callable, tree, *args):
    """``(fn(tree, *args), ∂fn/∂tree)`` by ``torch.autograd.grad``.

    The differentiable leaves are the floating tensors of ``tree``; a
    factor contributes ``U``, ``S`` and ``V``, and its ``rank`` gets a zero
    cotangent without ever being a leaf of the graph. The gradient tree has
    ``tree``'s structure. The value comes back detached.
    """
    leaves = []

    def live(t):
        t = t.detach().requires_grad_(True)
        leaves.append(t)
        return t

    def make(x):
        if is_factor(x):
            return dataclasses.replace(x, U=live(x.U), S=live(x.S), V=live(x.V))
        return live(x) if _leaf(x) else x

    with torch.enable_grad():
        tree_live = tree_map(make, tree, is_leaf=is_factor)
        value = fn(tree_live, *args)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    it = iter(torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads))

    def back(x):
        if is_factor(x):
            # repro-lint: disable=RPL005 -- a gradient tree in the factor's
            # shape, not a factor buffer: its callers mask it before use
            return dataclasses.replace(
                x, U=next(it), S=next(it), V=next(it), rank=torch.zeros_like(x.rank)
            )
        return next(it) if _leaf(x) else x

    return value.detach(), tree_map(back, tree, is_leaf=is_factor)


def grad(fn: Callable, tree, *args):
    return value_and_grad(fn, tree, *args)[1]


# ---------------------------------------------------------------------------
# shared building blocks
# ---------------------------------------------------------------------------


def first_step_batch(client_batches, cfg: FedConfig):
    """The cohort's step-0 batch: ``x[:, 0]`` under the per-step layout."""
    if cfg.per_step_batches:
        return tree_map(lambda x: x[:, 0], client_batches)
    return client_batches


def last_step_batch(client_batches, cfg: FedConfig):
    if cfg.per_step_batches:
        return tree_map(lambda x: x[:, -1], client_batches)
    return client_batches


def select_step_batch(batches, s: int, cfg: FedConfig):
    """One client's batch for local step ``s``."""
    if cfg.per_step_batches:
        return tree_map(lambda x: x[s], batches)
    return batches


def variance_correction(g_global, g_clients: Cohort) -> Cohort:
    """Control-variate term ``corr_c = ḡ − g_c`` (paper Eq. (4) / Eq. (8)),
    one tree per client: each local step adds it to ``∇L_c(w)`` so the
    expected client update follows the global gradient."""
    return Cohort(tree_map(torch.sub, g_global, gc) for gc in g_clients)


def local_sgd_scan(
    loss_fn: LossFn,
    params0,
    corr,
    batches,
    cfg: FedConfig,
    *,
    transform_grads: Optional[Callable[[Any], Any]] = None,
    project: Optional[Callable[[Any], Any]] = None,
    drift_fn: Optional[Callable[[Any], torch.Tensor]] = None,
):
    """One client's s* local (optionally corrected) SGD steps, as a loop.

    FeDLRT passes ``transform_grads``/``project`` to keep coefficient
    updates in the 2r active directions; the dense baselines use it bare.
    ``corr=None`` means uncorrected. ``drift_fn`` accumulates
    ``max_s drift_fn(params_s)``. Returns ``(params_s*, max_drift)``.
    """
    opt = make_optimizer(cfg.optimizer, cfg.lr, momentum=cfg.momentum)
    p, ost = params0, opt.init(params0)
    drift = torch.zeros((), device=tree_leaves(params0)[0].device)
    for s in range(cfg.s_star):
        g = grad(loss_fn, p, select_step_batch(batches, s, cfg))
        if corr is not None:
            g = tree_map(torch.add, g, corr)
        if transform_grads is not None:
            g = transform_grads(g)
        upd, ost = opt.update(g, ost, s, p)
        # cast: a f32 lr × bf16 grad promotes; the carried dtype stays put
        p = tree_map(lambda t, u: t + u.to(t.dtype), p, upd)
        if project is not None:
            p = project(p)
        if drift_fn is not None:
            drift = torch.maximum(drift, drift_fn(p))
    return p, drift
