"""Simulation engines: federated rounds priced on a virtual clock (the JAX
package's ``repro.fed.sim.engines``, in PyTorch).

Three engines share :class:`repro_torch.fed.engine.FederatedEngine`'s
interface (``train(batcher, rounds)``, ``params``, ``history``,
``comm_total_bytes()``) but differ in *when the server aggregates*:

- :class:`SyncSimEngine`: the synchronous engine with a clock attached.
  Each round's virtual duration is the **max** over the active cohort of
  ``download + compute + upload`` (the straggler barrier), priced from the
  cohort's :class:`~repro_torch.fed.sim.profiles.SystemProfile`s, the cost
  model's FLOP counts and the wire's measured bytes.
- :class:`AsyncFederatedEngine`: FedBuff-style buffered asynchrony. The
  server aggregates every ``buffer_size`` *arrivals*. Contributions carry
  the server version they departed from; staleness discounts their
  aggregation weight (``(1+s)^-staleness_power``) through the weighted
  ``ctx.aggregate``. Stale FeDLRT coefficient updates are transported
  between augmented bases by Galerkin projection
  (``Ū_aᵀ Ū_v · ΔS̃ · V̄_vᵀ V̄_a``) and re-masked to the anchor's active
  directions, so the zero-inactive-columns invariant holds exactly. With
  identical profiles and ``buffer_size == C`` every buffer is one
  zero-staleness full cohort, run through ``FederatedEngine.run_round``
  itself: the engine reproduces the synchronous one bit for bit.
- :class:`HierarchicalEngine`: two-tier edge → cloud federation. Each edge
  server runs ``edge_rounds`` ordinary synchronous rounds over its own
  clients; the edge → cloud hop crosses a second
  :class:`~repro_torch.fed.wire.Wire` with its own codec and byte tally;
  the cloud folds the edge models together by a weighted mean of the
  materialized weights and an SVD re-factorization per factor.

The round programs, kernels and codecs are untouched: the engines compose
them. Version snapshots of the async engine are the params trees
themselves, never copies: the round code writes only into fresh tensors,
so a snapshot stays the params it was taken from while clients that
departed from it are in flight.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import cost_model
from repro_torch.core.dlrt import coeff_grad_mask
from repro_torch.core.factorization import (
    LowRankFactor,
    is_factor,
    mask_coeff,
    materialize,
    rank_mask,
)
from repro_torch.core.fedlrt import trainable_of
from repro_torch.core.round import (
    _per_client_bytes,
    make_context,
    run_client_phases,
    split_server,
)
from repro_torch.fed.engine import FederatedEngine, RoundResult, _to_host, round_program_for
from repro_torch.fed.participation import Participation
from repro_torch.fed.sim.clock import Timeline, VirtualClock
from repro_torch.fed.sim.events import (
    ClientAvailable,
    ClientDropped,
    ClientFinished,
    EventQueue,
    ServerAggregate,
)
from repro_torch.fed.sim.profiles import Fleet, SystemProfile, client_round_flops
from repro_torch.fed.wire import Wire
from repro_torch.telemetry import default_hub, perf_seconds
from repro_torch.utils.tree import Cohort, tree_leaves, tree_map, tree_map_with_path


def _analytic_direction_bytes(params, method: str, correction: str):
    """Analytic (down, up) per-client bytes: the cold-start latency estimate
    before any measured round exists (and the only one with
    ``wire_codec=None``)."""
    try:
        d = cost_model.wire_round_bytes(params, method, correction=correction)
        return float(d["down"]), float(d["up"])
    except (ValueError, TypeError):
        # unknown method: price the full parameter tree each way
        size = float(sum(t.numel() * t.element_size() for t in tree_leaves(params)))
        return size, size


def _round_direction_bytes(res: RoundResult, params, method: str, correction: str):
    """(down, up) per-client bytes of a completed round: measured if the
    round was metered, else the analytic data-plane volumes."""
    if res.wire_codec and (res.wire_bytes_down_per_client or res.wire_bytes_up_per_client):
        return res.wire_bytes_down_per_client, res.wire_bytes_up_per_client
    return _analytic_direction_bytes(params, method, correction)


def _analytic_round_bytes(params, method: str, correction: str) -> float:
    """Per-client bytes of one round under the paper's multi-message
    protocol (the ``comm_bytes_per_client`` convention; 0.0 for methods the
    cost model does not know)."""
    with contextlib.suppress(ValueError, TypeError, KeyError):
        if method.startswith("fedlrt") and not method.startswith("fedlrt_naive"):
            return float(cost_model.fedlrt_round_comm_bytes(params, correction))
        if method in ("fedavg", "fedlin"):
            return float(cost_model.dense_round_comm_bytes(params, method))
    return 0.0


def _tree_concat(trees):
    """Batches of several dispatches along the client axis (host arrays,
    as the batcher gives them)."""
    return tree_map(lambda *xs: np.concatenate([np.asarray(x) for x in xs]), *trees)


def _first_client(batch):
    """Client 0's batch (its shapes and dtypes price the round's FLOPs)."""
    return tree_map(lambda a: a[0], batch)


def _resave_checkpoint_if_due(engine: FederatedEngine):
    """Checkpoints fire inside the base engine's round bookkeeping, before
    a sim engine sets the round's timing fields: save again so that the
    sidecar's history carries ``virtual_seconds`` / ``t_virtual`` /
    ``staleness_mean`` (same path, now-complete history)."""
    if (
        engine.checkpoint_dir
        and engine.checkpoint_every
        and engine.round_idx % engine.checkpoint_every == 0
    ):
        engine._save_checkpoint()


def _collect_ranks(params) -> dict:
    ranks = {}

    def visit(path, x):
        if is_factor(x):
            ranks[path] = x.rank.detach().cpu().numpy()
        return x

    tree_map_with_path(visit, params, is_leaf=is_factor)
    return ranks


def _galerkin(anchor, fv, d):
    """``Ū_aᵀ Ū_v · d · V̄_vᵀ V̄_a``: a coefficient delta in ``fv``'s bases
    moved into ``anchor``'s (batched over stacked factors)."""
    pu = torch.einsum("...nr,...nk->...rk", anchor.U, fv.U)
    pv = torch.einsum("...nk,...nr->...kr", fv.V, anchor.V)
    return torch.einsum("...rk,...kl,...lm->...rm", pu, d, pv)


# ---------------------------------------------------------------------------
# synchronous engine + virtual clock
# ---------------------------------------------------------------------------


class SyncSimEngine(FederatedEngine):
    """:class:`FederatedEngine` with rounds priced on a virtual clock.

    The same rounds as the plain engine, bit for bit; each round also
    advances a :class:`VirtualClock` by the straggler barrier (the slowest
    active client's ``download + compute + upload``) and records
    ``virtual_seconds`` / ``t_virtual`` on its :class:`RoundResult`.
    """

    def __init__(self, loss_fn, params, cfg, *, fleet: Optional[Fleet] = None,
                 flops_fn: Optional[Callable] = None, **kw):
        super().__init__(loss_fn, params, cfg, **kw)
        self.fleet = fleet if fleet is not None else Fleet.uniform(cfg.num_clients)
        if len(self.fleet) != cfg.num_clients:
            raise ValueError(
                f"fleet has {len(self.fleet)} profiles for {cfg.num_clients} clients"
            )
        self.flops_fn = flops_fn if flops_fn is not None else client_round_flops
        self.clock = VirtualClock()
        self.timeline = Timeline()
        self.telemetry.attach_clock(self.clock)

    def run_round(self, client_batches, *, cohort=None) -> RoundResult:
        one_client = _first_client(client_batches)
        res = super().run_round(client_batches, cohort=cohort)
        # FLOP pricing reads static shapes only, so post-round params price
        # the same round the pre-round params would
        flops = self.flops_fn(self.params, self.cfg, one_client)
        down, up = _round_direction_bytes(res, self.params, self.method, self.cfg.correction)
        dt = max(self.fleet[int(c)].round_seconds(flops, down, up) for c in res.cohort)
        t_prev = self.clock.now
        self.clock.advance_to(self.clock.now + dt)
        res.virtual_seconds = dt
        res.t_virtual = self.clock.now
        # the straggler barrier on the server's virtual track
        self.telemetry.span_at(
            "round", t_prev, self.clock.now,
            round=int(res.round_idx), cohort=int(res.cohort_size),
        )
        _resave_checkpoint_if_due(self)
        self.timeline.record(
            self.clock.now, "aggregate", round_idx=res.round_idx,
            detail=f"K={res.cohort_size}",
        )
        return res


# ---------------------------------------------------------------------------
# async (buffered) engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Pending:
    """One in-flight dispatch: the server version it departed from and the
    client's drawn batch (host arrays with a leading axis of 1)."""

    client: int
    version: int
    batch: dict
    t_dispatch: float


class AsyncFederatedEngine(FederatedEngine):
    """FedBuff-style buffered-asynchronous federated engine.

    Event-driven: every idle client is (re)dispatched at once from the
    *current* server params; its arrival lands at ``dispatch + download +
    compute + upload`` virtual seconds, priced by its
    :class:`SystemProfile`. The server folds the buffer into a new model
    version at every ``buffer_size``-th arrival.

    - Arrivals that departed from the current version follow the
      synchronous path: a buffer that is one such group is a
      :meth:`FederatedEngine.run_round` over the arrival cohort, so uniform
      fleets with ``buffer_size == num_clients`` reproduce the synchronous
      engine bit for bit.
    - Stale arrivals are re-anchored: their local coefficient deltas are
      transported between augmented bases by Galerkin projection, masked
      back to the anchor's active directions, and aggregated with
      staleness-discounted weights ``w_c ∝ base_c · (1 + s_c)^-p`` through
      the same weighted ``ctx.aggregate`` every synchronous round uses.

    Determinism: the event queue breaks ties by ``(time, client_id, push
    order)`` and dropout draws are seeded per ``(fleet seed, client,
    dispatch index)``, so two runs with the same seed give identical
    timelines and bit-identical params.
    """

    def __init__(
        self,
        loss_fn,
        params,
        cfg,
        *,
        fleet: Optional[Fleet] = None,
        buffer_size: Optional[int] = None,
        staleness_power: float = 0.5,
        flops_fn: Optional[Callable] = None,
        method: str = "fedlrt",
        participation: Optional[Participation] = None,
        **kw,
    ):
        if participation is not None and participation.mode != "full":
            raise ValueError(
                "AsyncFederatedEngine derives participation from client "
                "availability (profiles/dropout), not a Participation policy"
            )
        super().__init__(loss_fn, params, cfg, method=method, **kw)
        self.fleet = fleet if fleet is not None else Fleet.uniform(cfg.num_clients)
        if len(self.fleet) != cfg.num_clients:
            raise ValueError(
                f"fleet has {len(self.fleet)} profiles for {cfg.num_clients} clients"
            )
        self.buffer_size = int(buffer_size) if buffer_size else cfg.num_clients
        if self.buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
        self.staleness_power = float(staleness_power)
        self.flops_fn = flops_fn if flops_fn is not None else client_round_flops
        self.clock = VirtualClock()
        self.timeline = Timeline()
        self.telemetry.attach_clock(self.clock)
        self._program = round_program_for(method)
        self._queue = EventQueue()
        self._buffer: List[_Pending] = []  # arrivals awaiting aggregation
        self._pending: dict = {}  # (client, dispatch_idx) -> _Pending
        self._snapshots: dict = {}  # version -> [params, refcount]
        self._dispatch_count = [0] * cfg.num_clients
        self._t_last_flush = 0.0

    # -- event loop --------------------------------------------------------

    def train(self, batcher, num_rounds: int, *, log_every: int = 10):
        """Run until ``num_rounds`` more server aggregations completed.

        Each ``train`` call is one simulated run: in-flight work left over
        from a previous call is discarded (the virtual clock keeps counting
        up, histories concatenate).
        """
        self._batcher = batcher
        self._queue.clear()
        self._buffer.clear()
        self._pending.clear()
        self._snapshots.clear()
        target = self.round_idx + num_rounds
        idle = list(range(self.cfg.num_clients))
        dispatch_budget = 10_000 * max(num_rounds, 1)
        while self.round_idx < target:
            for c in sorted(idle):
                self._dispatch(c)
                dispatch_budget -= 1
            idle.clear()
            if dispatch_budget < 0:
                raise RuntimeError(
                    "async simulation dispatched >10k rounds per aggregation "
                    "— check the fleet's drop_prob / buffer_size"
                )
            if not self._queue:
                break  # nothing in flight and nothing to dispatch
            t = self._queue.peek_time()
            self.clock.advance_to(t)
            popped = self._queue.pop_until(t)
            self.telemetry.counter("sim.events_popped", len(popped))
            for ev in popped:
                if isinstance(ev, ClientFinished):
                    p = self._pending.pop((ev.client_id, ev.dispatch_idx))
                    self._buffer.append(p)
                    self.timeline.record(
                        t, "arrive", client=ev.client_id, round_idx=p.version,
                        detail=f"stale={self.round_idx - p.version}",
                    )
                    # the client's whole virtual round on its own track
                    self.telemetry.span_at(
                        "client_round", p.t_dispatch, t,
                        client=int(ev.client_id), version=int(p.version),
                        staleness=int(self.round_idx - p.version),
                    )
                    idle.append(ev.client_id)
                    if len(self._buffer) >= self.buffer_size and self.round_idx < target:
                        res = self._flush()
                        if log_every and res.round_idx % log_every == 0:
                            self.telemetry.progress(
                                f"[async/{self.method}] round {res.round_idx:4d} "
                                f"loss {res.loss_before:.4f} "
                                f"t={res.t_virtual:.1f}s "
                                f"stale={res.staleness_mean:.2f}",
                                round=int(res.round_idx),
                            )
                elif isinstance(ev, ClientDropped):
                    p = self._pending.pop((ev.client_id, ev.dispatch_idx))
                    self._release(p.version)
                    self.timeline.record(t, "drop", client=ev.client_id, round_idx=p.version)
                    self.telemetry.span_at(
                        "client_dropped", p.t_dispatch, t,
                        client=int(ev.client_id), version=int(p.version),
                    )
                    delay = self.fleet[ev.client_id].rejoin_delay_sec
                    if delay > 0:
                        self._queue.push(ClientAvailable(time=t + delay, client_id=ev.client_id))
                    else:
                        idle.append(ev.client_id)
                elif isinstance(ev, ClientAvailable):
                    idle.append(ev.client_id)
        return self.history

    def _dispatch(self, client: int):
        t = self.clock.now
        didx = self._dispatch_count[client]
        self._dispatch_count[client] += 1
        version = self.round_idx
        batch = self._batcher.next_round([client])
        flops = self.flops_fn(self.params, self.cfg, _first_client(batch))
        down, up = self._bytes_estimate()
        dt = self.fleet[client].round_seconds(flops, down, up)
        dropped, frac = self.fleet.drop_draw(client, didx)
        self._hold(version)
        self._pending[(client, didx)] = _Pending(
            client=client, version=version, batch=batch, t_dispatch=t
        )
        cls = ClientDropped if dropped else ClientFinished
        self._queue.push(cls(
            time=t + (frac * dt if dropped else dt),
            client_id=client, version=version, dispatch_idx=didx,
        ))
        self.timeline.record(t, "dispatch", client=client, round_idx=version)

    def _bytes_estimate(self):
        """Per-direction bytes for latency pricing: the last round's
        *measured* wire bytes once one exists, the analytic data-plane
        volumes before that."""
        if self.history:
            return _round_direction_bytes(
                self.history[-1], self.params, self.method, self.cfg.correction
            )
        return _analytic_direction_bytes(self.params, self.method, self.cfg.correction)

    def _hold(self, version: int):
        """Pin the current params as ``version``'s snapshot (a reference, not
        a copy: nothing writes into a params tensor after it is made)."""
        slot = self._snapshots.get(version)
        if slot is None:
            self._snapshots[version] = [self.params, 1]
        else:
            slot[1] += 1

    def _release(self, version: int):
        slot = self._snapshots[version]
        slot[1] -= 1
        if slot[1] == 0:
            del self._snapshots[version]

    # -- aggregation -------------------------------------------------------

    def _flush(self) -> RoundResult:
        t = self.clock.now
        arrivals = list(self._buffer)
        self._buffer.clear()
        staleness = [self.round_idx - a.version for a in arrivals]
        if all(s == 0 for s in staleness):
            # the whole buffer departed from the current params: exactly a
            # synchronous round over the arrival cohort (with identical
            # profiles and buffer_size == C, the plain engine bit for bit)
            batch = _tree_concat([a.batch for a in arrivals])
            res = super().run_round(batch, cohort=np.asarray([a.client for a in arrivals]))
        else:
            res = self._flush_stale(arrivals)
        for a in arrivals:
            self._release(a.version)
        res.virtual_seconds = t - self._t_last_flush
        res.t_virtual = t
        res.staleness_mean = float(np.mean(staleness))
        # inter-flush interval on the server's virtual track
        self.telemetry.span_at(
            "aggregate", self._t_last_flush, t,
            round=int(res.round_idx), buffer_fill=len(arrivals),
        )
        self.telemetry.gauge("staleness_mean", res.staleness_mean, round=int(res.round_idx))
        self._t_last_flush = t
        _resave_checkpoint_if_due(self)
        ev = ServerAggregate(
            time=t, client_id=-1, version=res.round_idx, buffer_fill=len(arrivals),
        )
        self.timeline.record(
            ev.time, "aggregate", client=ev.client_id, round_idx=ev.version,
            detail=f"K={ev.buffer_fill};stale={res.staleness_mean:g}",
        )
        return res

    def _run_group(self, version: int, group: Sequence[_Pending]):
        """Client phases of one staleness group, at the params the group
        departed from. The broadcast (basis augmentation, variance
        correction) is computed over the *group* at the departure point, so
        the corrections stay anchored to each client's departure basis.
        Returns ``(shared, client outputs as a Cohort, down bytes, up
        bytes)``, the bytes summed over the group."""
        params_v = self._snapshots[version][0]
        batch = self._to_device(_tree_concat([p.batch for p in group]))
        cfg_k = dataclasses.replace(self.cfg, num_clients=len(group))
        w = (
            None if self.client_weights is None
            else np.asarray(self.client_weights[[p.client for p in group]], np.float32)
        )
        ctx = make_context(cfg_k, round_idx=version, client_weights=w)
        shared, outs, nbytes = run_client_phases(
            self._program, self._loss_fn, params_v, batch, ctx, wire=self.wire
        )
        # python floats, then the f32 per-client split, as the JAX package
        # reads its jitted counts back
        bs, bpc, bup = (float(b) for b in nbytes)
        per_down = float(_per_client_bytes(bs, bpc, len(group)))
        return shared, outs, per_down * len(group), bup

    def _transport_out(self, out, shared_v, shared_a):
        """Re-anchor one stale client output into the anchor broadcast's
        coefficient space, as a pseudo client output.

        FeDLRT: ``S̃_pseudo = S̃⁰_a + mask_a(Ū_aᵀ Ū_v (S̃_c − S̃⁰_v) V̄_vᵀ V̄_a)``,
        the weight-space delta Galerkin-projected onto the anchor's
        augmented basis and re-masked to its active block, so the
        zero-inactive-columns invariant holds exactly. Dense programs
        re-anchor the plain parameter delta; programs whose client outputs
        are absolute (the naive baseline's) pass through unchanged.
        """
        if isinstance(shared_a, dict) and "aug_params" in shared_a:
            tr, drift = out
            aug_a, aug_v = shared_a["aug_params"], shared_v["aug_params"]
            delta = tree_map(torch.sub, tr, trainable_of(aug_v))

            def one(fa, fv, ra, d):
                if is_factor(fa):
                    return ra + mask_coeff(_galerkin(fa, fv, d), coeff_grad_mask(fa))
                return ra + d

            pseudo = tree_map(one, aug_a, aug_v, trainable_of(aug_a), delta, is_leaf=is_factor)
            return pseudo, drift
        if isinstance(shared_a, dict) and "params0" in shared_a:
            delta = tree_map(torch.sub, out, shared_v["params0"])
            return tree_map(torch.add, shared_a["params0"], delta)
        return out  # absolute outputs (weight-space aggregation)

    def _server_delta(self, out, shared_v):
        """One stale output as a delta in the *current server params'*
        coefficient space (factor leaves: Galerkin projection onto the
        truncated basis, masked to its active rank)."""
        if isinstance(shared_v, dict) and "aug_params" in shared_v:
            tr, _drift = out
            aug_v = shared_v["aug_params"]
            delta = tree_map(torch.sub, tr, trainable_of(aug_v))

            def one(ps, fv, d):
                if is_factor(ps):
                    d2 = _galerkin(ps, fv, d)
                    return mask_coeff(d2, rank_mask(ps.rank, ps.r_max, dtype=d2.dtype))
                return d

            return tree_map(one, self.params, aug_v, delta, is_leaf=is_factor)
        if isinstance(shared_v, dict) and "params0" in shared_v:
            return tree_map(torch.sub, out, shared_v["params0"])
        raise NotImplementedError(
            f"method {self.method!r} has no delta form for fully-stale buffered aggregation"
        )

    def _discounted_weights(self, arrivals: Sequence[_Pending]) -> np.ndarray:
        base = (
            self.client_weights[[a.client for a in arrivals]]
            if self.client_weights is not None
            else np.ones(len(arrivals), np.float32)
        )
        stale = np.asarray([self.round_idx - a.version for a in arrivals], np.float32)
        return np.asarray(base * (1.0 + stale) ** (-self.staleness_power), np.float32)

    def _flush_stale(self, arrivals: Sequence[_Pending]) -> RoundResult:
        """Aggregate a mixed-staleness buffer.

        Groups arrivals by departure version and runs each group's client
        phases at its own departure params. If some arrivals departed from
        the *current* version, that group's broadcast is the anchor: stale
        outputs become transported pseudo-outputs in the anchor's
        coefficient space and the whole buffer flows through the ordinary
        ``aggregate → finalize`` (truncation included) with
        staleness-discounted weights. If every arrival is stale, the buffer
        is applied FedBuff-style: discounted deltas projected onto the
        current params, no rank adaptation this round.
        """
        t0 = perf_seconds()
        program, cfg = self._program, self.cfg
        K = len(arrivals)
        groups: dict = {}
        for i, a in enumerate(arrivals):
            groups.setdefault(a.version, []).append(i)
        shared_by_v, outs_by_i = {}, [None] * K
        bytes_down = bytes_up = 0.0
        for v in sorted(groups):
            idxs = groups[v]
            with self.telemetry.span(
                "phase.client_step", version=int(v), group=len(idxs), round=int(self.round_idx),
            ):
                shared, outs, bdown, bup = self._run_group(v, [arrivals[i] for i in idxs])
            shared_by_v[v] = shared
            for j, i in enumerate(idxs):
                outs_by_i[i] = outs[j]
            bytes_down += bdown
            bytes_up += bup
        w = self._discounted_weights(arrivals)
        anchor_v = max(groups)
        if anchor_v == self.round_idx:
            shared_a = shared_by_v[anchor_v]
            pseudo = Cohort(
                outs_by_i[i]
                if arrivals[i].version == anchor_v
                else self._transport_out(outs_by_i[i], shared_by_v[arrivals[i].version], shared_a)
                for i in range(K)
            )
            ctx = make_context(
                dataclasses.replace(cfg, num_clients=K), round_idx=self.round_idx,
                client_weights=w,
            )
            with self.telemetry.span("phase.aggregate", round=int(self.round_idx), cohort=K):
                agg = program.aggregate(shared_a, pseudo, ctx)
            batches = self._to_device(_tree_concat([a.batch for a in arrivals]))
            with self.telemetry.span("phase.finalize", round=int(self.round_idx), cohort=K):
                new_params, metrics = program.finalize(
                    self._loss_fn, self.params, shared_a, agg, batches, ctx
                )
                metrics = _to_host(metrics)
            pub_metrics = metrics
            loss_after = float(metrics["loss_after"]) if "loss_after" in metrics else None
            loss_before = float(metrics["loss_before"])
            comm = float(metrics.get("comm_bytes_per_client", 0.0))
            comm_eff = float(metrics.get("comm_bytes_per_client_effective", 0.0))
            ranks = metrics.get("rank", {})
            if not isinstance(ranks, dict):
                ranks = {"": ranks}
            ranks = {k: np.asarray(v) for k, v in ranks.items()}
        else:
            # no current-version group: fold the discounted deltas into the
            # current params (pure FedBuff application, basis unchanged)
            wn = w / w.sum()
            deltas = [
                self._server_delta(outs_by_i[i], shared_by_v[arrivals[i].version])
                for i in range(K)
            ]
            dsum = tree_map(lambda *xs: sum(float(wi) * x for wi, x in zip(wn, xs)), *deltas)

            def apply(ps, d):
                if is_factor(ps):
                    return dataclasses.replace(ps, S=ps.S + d)
                return ps + d

            new_params = tree_map(apply, self.params, dsum, is_leaf=is_factor)
            _, server_state = split_server(shared_by_v[anchor_v])
            loss_before = (
                float(server_state["loss_before"])
                if server_state and "loss_before" in server_state
                else float("nan")
            )
            loss_after = None
            # no finalize ran, so no metrics: the analytic figure, so that
            # comm_total_bytes_analytic() keeps counting these rounds
            comm = _analytic_round_bytes(self.params, self.method, cfg.correction)
            comm_eff = 0.0
            ranks = _collect_ranks(new_params)
            pub_metrics = {}
        self.params = new_params
        res = RoundResult(
            round_idx=self.round_idx,
            loss_before=loss_before,
            loss_after=loss_after,
            comm_bytes_per_client=comm,
            ranks=ranks,
            seconds=perf_seconds() - t0,
            cohort_size=K,
            cohort=np.asarray([a.client for a in arrivals]),
            comm_bytes_per_client_effective=comm_eff,
            wire_bytes_down_per_client=bytes_down / K if self.wire else 0.0,
            wire_bytes_up_per_client=bytes_up / K if self.wire else 0.0,
            wire_codec=self.wire.name if self.wire is not None else "",
        )
        self.history.append(res)
        self._publish_round(res, pub_metrics)
        self.round_idx += 1
        if (
            self.checkpoint_dir
            and self.checkpoint_every
            and self.round_idx % self.checkpoint_every == 0
        ):
            self._save_checkpoint()
        return res


# ---------------------------------------------------------------------------
# hierarchical (edge → cloud) engine
# ---------------------------------------------------------------------------


class HierarchicalEngine:
    """Two-tier federation: edge servers aggregate their own clients with
    ordinary synchronous rounds; the cloud periodically folds the edge
    models together.

    Clients are split contiguously across ``num_edges`` edges. One cloud
    round: every edge receives the cloud model through the edge ↔ cloud
    :class:`Wire` (its own codec and byte tally), runs ``edge_rounds``
    local :meth:`FederatedEngine.run_round`s over its clients, and uploads
    its model for the cloud aggregate: a weighted mean of the materialized
    weights per factor leaf, re-factorized by SVD at the edge ranks'
    elementwise max.

    Virtual time: edges run in parallel; a cloud round costs
    ``max_e(downlink_e + Σ local rounds' straggler barriers + uplink_e)``.
    """

    def __init__(
        self,
        loss_fn,
        params,
        cfg,
        *,
        method: str = "fedlrt",
        num_edges: int = 2,
        edge_rounds: int = 1,
        fleet: Optional[Fleet] = None,
        edge_profiles=None,
        wire_codec="identity",
        edge_wire_codec=None,
        client_weights=None,
        flops_fn: Optional[Callable] = None,
        eval_fn=None,
        telemetry=None,
    ):
        C = cfg.num_clients
        if not 1 <= num_edges <= C:
            raise ValueError(f"num_edges must be in [1, {C}], got {num_edges}")
        self.cfg = cfg
        self.method = method
        self.params = params
        self.num_edges = int(num_edges)
        self.edge_rounds = int(edge_rounds)
        self.fleet = fleet if fleet is not None else Fleet.uniform(C)
        self.flops_fn = flops_fn if flops_fn is not None else client_round_flops
        self.eval_fn = eval_fn
        self.history: List[RoundResult] = []
        self.round_idx = 0
        self.clock = VirtualClock()
        self.timeline = Timeline()
        self.telemetry = telemetry if telemetry is not None else default_hub()
        self.telemetry.attach_clock(self.clock)
        self.edge_cohorts = [np.asarray(c) for c in np.array_split(np.arange(C), num_edges)]
        # the edge ↔ cloud backhaul: typically far fatter than client links
        if edge_profiles is None:
            backhaul = SystemProfile(
                flops_per_sec=1e12, up_bytes_per_sec=1.25e8,
                down_bytes_per_sec=1.25e8, latency_sec=0.02, name="backhaul",
            )
            edge_profiles = [backhaul] * num_edges
        self.edge_profiles = list(edge_profiles)
        self.edge_wire = Wire(
            edge_wire_codec if edge_wire_codec is not None else wire_codec,
            telemetry=self.telemetry,
        )
        self._cloud_bytes = 0.0
        self._loss_fn = loss_fn
        self.client_weights = (
            None if client_weights is None else np.asarray(client_weights, np.float32)
        )
        self.edge_engines = []
        for cohort in self.edge_cohorts:
            cw = self.client_weights[cohort] if self.client_weights is not None else None
            self.edge_engines.append(
                # repro-lint: disable=RPL001 -- one plain engine per edge is
                # this engine's own state, built by the engine that build()
                # constructs; the lint's path rules know only the JAX tree
                FederatedEngine(
                    loss_fn, params,
                    dataclasses.replace(cfg, num_clients=len(cohort)),
                    method=method, wire_codec=wire_codec,
                    client_weights=cw, telemetry=self.telemetry,
                )
            )
        # cloud-side aggregation weight of each edge ∝ its population mass
        self.edge_weights = np.asarray(
            [
                self.client_weights[c].sum() if self.client_weights is not None else float(len(c))
                for c in self.edge_cohorts
            ],
            np.float64,
        )

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.params)[0].device

    def _edge_hop(self, tree, name):
        decoded, nbytes = self.edge_wire.roundtrip(tree, name=name)
        return decoded, float(nbytes)

    def _cloud_aggregate(self, edge_params: List):
        """Weight-space weighted mean + per-factor SVD re-factorization."""
        w = self.edge_weights / self.edge_weights.sum()

        def one(*leaves):
            f0 = leaves[0]
            if is_factor(f0):
                W = sum(float(wi) * materialize(f) for wi, f in zip(w, leaves))
                # cuSOLVER's default Jacobi driver (gesvdj) rebuilds f32
                # factors of llm-100m's width far less accurately than the
                # QR-based gesvd, which matches LAPACK on the CPU
                # (chip_smoke.py's sim phase measures both)
                driver = "gesvd" if W.is_cuda else None
                P, s, Qt = torch.linalg.svd(W, full_matrices=False, driver=driver)
                r_max = f0.r_max
                rank = f0.rank
                for f in leaves[1:]:
                    rank = torch.maximum(rank, f.rank)
                keep = rank_mask(rank, r_max, dtype=s.dtype)
                U = P[..., :, :r_max] * keep[..., None, :]
                V = Qt.mT[..., :, :r_max] * keep[..., None, :]
                eye = torch.eye(r_max, dtype=s.dtype, device=s.device)
                S = (s[..., :r_max] * keep)[..., :, None] * eye
                return LowRankFactor(
                    U=U.to(f0.U.dtype), S=S.to(f0.S.dtype), V=V.to(f0.V.dtype), rank=rank,
                )
            return sum(float(wi) * x for wi, x in zip(w, leaves))

        return tree_map(one, *edge_params, is_leaf=is_factor)

    def train(self, batcher, num_rounds: int, *, log_every: int = 10):
        """``num_rounds`` *cloud* rounds (each: ``edge_rounds`` local rounds
        on every edge plus the edge ↔ cloud exchange)."""
        for _ in range(num_rounds):
            t0 = self.clock.now
            # cloud → edge broadcast (one payload, received by every edge)
            down_dec, down_bytes = self._edge_hop(self.params, "edge_down")
            self._cloud_bytes += down_bytes * self.num_edges
            edge_times, edge_losses, up_list, up_bytes_list = [], [], [], []
            for e, eng in enumerate(self.edge_engines):
                eng.params = down_dec
                t_e = self.edge_profiles[e].down_seconds(down_bytes)
                for _j in range(self.edge_rounds):
                    batch = batcher.next_round(self.edge_cohorts[e])
                    one_client = _first_client(batch)
                    res = eng.run_round(batch)
                    flops = self.flops_fn(eng.params, eng.cfg, one_client)
                    down, up = _round_direction_bytes(
                        res, eng.params, self.method, self.cfg.correction
                    )
                    t_e += max(
                        self.fleet[int(c)].round_seconds(flops, down, up)
                        for c in self.edge_cohorts[e]
                    )
                edge_losses.append(eng.history[-self.edge_rounds].loss_before)
                up_dec, up_bytes = self._edge_hop(eng.params, "edge_up")
                self._cloud_bytes += up_bytes
                up_list.append(up_dec)
                up_bytes_list.append(up_bytes)
                t_e += self.edge_profiles[e].up_seconds(up_bytes)
                edge_times.append(t_e)
                self.timeline.record(t0 + t_e, "edge_up", client=e, round_idx=self.round_idx)
                # one edge's down → local rounds → up window on its own track
                self.telemetry.span_at(
                    "edge_round", t0, t0 + t_e, client=int(e), round=int(self.round_idx),
                )
            self.params = self._cloud_aggregate(up_list)
            dt = max(edge_times)
            self.clock.advance_to(t0 + dt)
            ew = self.edge_weights / self.edge_weights.sum()
            res = RoundResult(
                round_idx=self.round_idx,
                loss_before=float(np.dot(ew, np.asarray(edge_losses))),
                loss_after=None,
                comm_bytes_per_client=0.0,
                ranks=_collect_ranks(self.params),
                seconds=0.0,
                cohort_size=self.num_edges,
                cohort=np.arange(self.num_edges),
                wire_bytes_down_per_client=down_bytes,
                wire_bytes_up_per_client=float(np.mean(up_bytes_list)),
                wire_codec=self.edge_wire.name,
                virtual_seconds=dt,
                t_virtual=self.clock.now,
            )
            self.history.append(res)
            self.round_idx += 1
            self.timeline.record(
                self.clock.now, "aggregate", round_idx=res.round_idx,
                detail=f"edges={self.num_edges}",
            )
            self.telemetry.span_at(
                "cloud_round", t0, self.clock.now,
                round=int(res.round_idx), edges=int(self.num_edges),
            )
            if log_every and res.round_idx % log_every == 0:
                self.telemetry.progress(
                    f"[hier/{self.method}] cloud round {res.round_idx:4d} "
                    f"loss {res.loss_before:.4f} t={res.t_virtual:.1f}s",
                    round=int(res.round_idx),
                )
        return self.history

    def comm_total_bytes(self) -> float:
        """Client-tier measured bytes (summed over the edge engines) plus the
        edge ↔ cloud tier's own tally."""
        return float(sum(e.comm_total_bytes() for e in self.edge_engines) + self._cloud_bytes)

    def evaluate(self, batch) -> float:
        assert self.eval_fn is not None
        return float(self.eval_fn(self.params, self.edge_engines[0]._to_device(batch)))


# ---------------------------------------------------------------------------
# factory (the CLI surface)
# ---------------------------------------------------------------------------


def make_sim_engine(
    engine: str,
    loss_fn,
    params,
    cfg,
    *,
    sim_profile: Optional[str] = None,
    fleet: Optional[Fleet] = None,
    seed: int = 0,
    buffer_size: Optional[int] = None,
    staleness_power: float = 0.5,
    num_edges: int = 2,
    edge_rounds: int = 1,
    edge_wire_codec=None,
    **kw,
):
    """Build a simulation engine from CLI-style specs.

    ``engine``: ``sync`` | ``async`` | ``hier``. ``sim_profile`` is a
    :meth:`Fleet.from_spec` string (default ``uniform``); an explicit
    ``fleet`` overrides it.
    """
    if fleet is None:
        fleet = Fleet.from_spec(sim_profile or "uniform", cfg.num_clients, seed=seed)
    if engine == "sync":
        # repro-lint: disable=RPL001 -- the simulator's factory, called only
        # from the port's build() seam (repro_torch.api.experiment)
        return SyncSimEngine(loss_fn, params, cfg, fleet=fleet, **kw)
    if engine == "async":
        # repro-lint: disable=RPL001 -- the simulator's factory (see above)
        return AsyncFederatedEngine(
            loss_fn, params, cfg, fleet=fleet, buffer_size=buffer_size,
            staleness_power=staleness_power, **kw,
        )
    if engine == "hier":
        # loud, not lossy: the hier engine supports neither checkpointing
        # nor Participation policies; refusing beats dropping the request
        participation = kw.pop("participation", None)
        if participation is not None and participation.mode != "full":
            raise ValueError(
                "the hier engine runs full participation within each edge; "
                f"got participation mode {participation.mode!r}"
            )
        if kw.pop("checkpoint_dir", None) or kw.pop("checkpoint_every", 0):
            raise ValueError("the hier engine does not support checkpointing yet")
        kw.pop("checkpoint_meta", None)  # nothing to stamp without checkpoints
        # repro-lint: disable=RPL001 -- the simulator's factory (see above)
        return HierarchicalEngine(
            loss_fn, params, cfg, fleet=fleet, num_edges=num_edges,
            edge_rounds=edge_rounds, edge_wire_codec=edge_wire_codec, **kw,
        )
    raise ValueError(f"unknown engine {engine!r}; expected sync | async | hier")
