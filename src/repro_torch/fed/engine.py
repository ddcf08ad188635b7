"""Federated training engine: the multi-round loop over any round method
(the synchronous engine of the JAX package's ``repro.fed.engine``).

The engine owns the host-side loop: cohort selection through a
:class:`~repro_torch.fed.participation.Participation` policy, batches from
a :class:`~repro_torch.data.FederatedBatcher` moved to the params' device,
the round call, the metric history and evaluation. ``dropout``
participation, the one policy whose cohort size varies, is padded to the
population size with zero-weight repeats of active clients, as in the JAX
package (there it keeps one jit executable; here it keeps the round's
shapes and work the same as the reference's).

The wire: the engine owns a :class:`~repro_torch.fed.wire.Wire`
(``wire_codec``, default ``"identity"``) and threads it through every round's
phase boundaries, so :meth:`FederatedEngine.comm_total_bytes` sums what the
codec shipped; the analytic cost-model figure stays available as
:meth:`FederatedEngine.comm_total_bytes_analytic`.

Restartability: every ``checkpoint_every`` rounds the engine writes
``{checkpoint_dir}/round_{idx:06d}.npz`` in the JAX package's format plus a
versioned ``.state.npy`` sidecar (round history, batcher stream state);
:meth:`FederatedEngine.restore` resumes a run that then replays the
remaining rounds bit-identically. Checkpoints move between the two
packages in both directions.

The system simulator's engines (virtual clock, async FedBuff, the
hierarchical edge → cloud engine) build on this one in
:mod:`repro_torch.fed.sim`.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core.baselines import (
    FedAvgProgram,
    FedLinProgram,
    FedLRTNaiveProgram,
    fedavg_round,
    fedlin_round,
    fedlrt_naive_round,
)
from repro_torch.core.fedlrt import FedLRTProgram, fedlrt_round
from repro_torch.core.round import FedConfig
from repro_torch.fed.participation import Participation
from repro_torch.fed.wire import Wire
from repro_torch.telemetry import default_hub, perf_seconds
from repro_torch.utils.tree import tree_leaves, tree_map

#: round-method registry: name → round function. Extend via
#: :func:`register_round_method`, never by editing this module.
ROUND_METHODS: Dict[str, Callable] = {}

#: name → zero-arg factory of the method's RoundProgram (None for methods
#: registered without one)
ROUND_PROGRAMS: Dict[str, Optional[Callable]] = {}


def register_round_method(name: str, fn: Callable, *, program=None, overwrite=False):
    """Register a federated round method under ``name``: ``fn(loss_fn,
    params, client_batches, cfg, *, round_idx, client_weights, wire) →
    (new_params, metrics)``, and optionally a zero-arg ``program`` factory
    of its RoundProgram. Re-registration needs ``overwrite=True``."""
    if not overwrite and name in ROUND_METHODS:
        raise ValueError(
            f"round method {name!r} is already registered "
            f"(pass overwrite=True to replace it)"
        )
    ROUND_METHODS[name] = fn
    ROUND_PROGRAMS[name] = program


def round_program_for(method: str):
    """Instantiate the registered RoundProgram for ``method``."""
    factory = ROUND_PROGRAMS.get(method)
    if factory is None:
        raise ValueError(
            f"round method {method!r} has no registered RoundProgram; "
            f"register_round_method(..., program=...) to enable phase-level "
            f"engines"
        )
    return factory()


register_round_method("fedlrt", fedlrt_round, program=FedLRTProgram)
register_round_method("fedavg", fedavg_round, program=FedAvgProgram)
register_round_method("fedlin", fedlin_round, program=FedLinProgram)
register_round_method("fedlrt_naive", fedlrt_naive_round, program=FedLRTNaiveProgram)


@dataclasses.dataclass
class RoundResult:
    """One round's record, with the JAX package's fields."""

    round_idx: int
    loss_before: float
    loss_after: Optional[float]
    comm_bytes_per_client: float
    ranks: Dict[str, np.ndarray]
    seconds: float
    cohort_size: int = 0
    cohort: Optional[np.ndarray] = None
    comm_bytes_per_client_effective: float = 0.0
    # *measured* wire-layer bytes (per client, per direction): what the
    # round's codec put on the wire (repro_torch.fed.wire)
    wire_bytes_down_per_client: float = 0.0
    wire_bytes_up_per_client: float = 0.0
    wire_codec: str = ""
    # virtual-clock timing (repro_torch.fed.sim): how long the round took in
    # simulated seconds and the clock reading at its end; 0.0 when the run
    # is not priced through a system simulator
    virtual_seconds: float = 0.0
    t_virtual: float = 0.0
    # mean staleness (server versions) of the aggregated contributions;
    # always 0.0 for synchronous rounds
    staleness_mean: float = 0.0


#: version tag of the JAX package's checkpoint state sidecar, whose history
#: format these helpers write and read
STATE_VERSION = 1


def history_to_state(history: List[RoundResult]) -> List[dict]:
    """``history`` as JSON-safe dicts (the v1 sidecar representation)."""
    out = []
    for r in history:
        d = dataclasses.asdict(r)
        d["ranks"] = {k: np.asarray(v).tolist() for k, v in r.ranks.items()}
        d["cohort"] = None if r.cohort is None else np.asarray(r.cohort).tolist()
        out.append(d)
    return out


def history_from_state(rounds: List[dict]) -> List[RoundResult]:
    """Inverse of :func:`history_to_state`, tolerant of field drift: keys
    the dataclass lacks are dropped, missing fields take their defaults
    (a sidecar written before the virtual-clock fields existed reads with
    0.0 for them)."""
    fields = {f.name for f in dataclasses.fields(RoundResult)}
    out = []
    for d in rounds:
        d = {k: v for k, v in d.items() if k in fields}
        if d.get("ranks") is not None:
            d["ranks"] = {k: np.asarray(v) for k, v in d["ranks"].items()}
        if d.get("cohort") is not None:
            d["cohort"] = np.asarray(d["cohort"])
        out.append(RoundResult(**d))
    return out


class FederatedEngine:
    def __init__(
        self,
        loss_fn: Callable,
        params,
        cfg: FedConfig,
        *,
        method: str = "fedlrt",
        participation: Optional[Participation] = None,
        eval_fn: Optional[Callable] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        client_weights=None,
        wire_codec="identity",
        checkpoint_meta: Optional[dict] = None,
        telemetry=None,
    ):
        if method not in ROUND_METHODS:
            raise ValueError(f"method must be one of {list(ROUND_METHODS)}")
        self.cfg = cfg
        self.method = method
        self.params = params
        self.participation = participation if participation is not None else Participation()
        self.eval_fn = eval_fn
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        # stamped into every checkpoint (e.g. the spec hash resume() checks)
        self.checkpoint_meta = dict(checkpoint_meta) if checkpoint_meta else {}
        self.history: List[RoundResult] = []
        self.round_idx = 0
        self.client_weights = (
            None if client_weights is None else np.asarray(client_weights, np.float32)
        )
        # the engine only ever reads state into the hub: instrumentation
        # cannot perturb a run
        self.telemetry = telemetry if telemetry is not None else default_hub()
        self._loss_fn = loss_fn
        self._round_fn = ROUND_METHODS[method]
        self._batcher = None  # set by train(); snapshotted into checkpoints
        # every round's data plane passes through the wire, so comm is
        # measured; wire_codec=None opts out (payloads as they are, no meter)
        self.wire: Optional[Wire] = None if wire_codec is None else Wire(wire_codec)

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.params)[0].device

    def _to_device(self, batch):
        dev = self.device
        return tree_map(
            lambda a: (a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))).to(dev),
            batch,
        )

    def run_round(self, client_batches, *, cohort=None) -> RoundResult:
        """One aggregation round on ``client_batches`` (numpy or tensors,
        leading axis = the active cohort). ``cohort`` (optional index
        array) attributes the rows to population clients: it slices
        ``client_weights`` and is recorded in the history.

        Under ``dropout`` participation the batch is padded to the
        population size with repeats of active clients that carry zero
        aggregation weight: inert in every (weight-normalized) aggregate.
        Comm accounting and ``cohort_size`` stay at the true cohort size.
        """
        t0 = perf_seconds()
        client_batches = self._to_device(client_batches)
        k = tree_leaves(client_batches)[0].shape[0]
        cohort = np.arange(k) if cohort is None else np.asarray(cohort)
        pad_to = self.participation.padded_size(self.cfg.num_clients)
        with self.telemetry.span("round.step", round=int(self.round_idx), cohort=int(k)):
            if pad_to is not None:
                w = (
                    np.asarray(self.client_weights[cohort], np.float32)
                    if self.client_weights is not None
                    else np.ones(k, np.float32)
                )
                if k < pad_to:
                    fill = np.arange(pad_to - k) % k  # repeat active clients
                    idx = torch.as_tensor(np.concatenate([np.arange(k), fill]))
                    client_batches = tree_map(
                        lambda a: a[idx.to(a.device)], client_batches
                    )
                w = np.concatenate([w, np.zeros(pad_to - k, np.float32)])
                size = pad_to
            else:
                w = None if self.client_weights is None else self.client_weights[cohort]
                size = k
            cfg_k = dataclasses.replace(self.cfg, num_clients=size)
            self.params, metrics = self._round_fn(
                self._loss_fn, self.params, client_batches, cfg_k,
                round_idx=self.round_idx, client_weights=w, wire=self.wire,
            )
            metrics = _to_host(metrics)
        ranks = metrics.get("rank", {})
        if not isinstance(ranks, dict):  # single-factor methods (naive)
            ranks = {"": ranks}
        res = RoundResult(
            round_idx=self.round_idx,
            loss_before=float(metrics["loss_before"]),
            loss_after=float(metrics["loss_after"]) if "loss_after" in metrics else None,
            comm_bytes_per_client=float(metrics.get("comm_bytes_per_client", 0.0)),
            ranks={k_: np.asarray(v) for k_, v in ranks.items()},
            seconds=perf_seconds() - t0,
            cohort_size=k,
            cohort=cohort,
            comm_bytes_per_client_effective=float(
                metrics.get("comm_bytes_per_client_effective", 0.0)
            ),
            wire_bytes_down_per_client=float(metrics.get("wire_bytes_down_per_client", 0.0)),
            wire_bytes_up_per_client=float(metrics.get("wire_bytes_up_per_client", 0.0)),
            wire_codec=self.wire.name if self.wire is not None else "",
        )
        self.history.append(res)
        self._publish_round(res, metrics)
        self.round_idx += 1
        if (
            self.checkpoint_dir
            and self.checkpoint_every
            and self.round_idx % self.checkpoint_every == 0
        ):
            self._save_checkpoint()
        return res

    def _publish_round(self, res: RoundResult, metrics: dict) -> None:
        """Per-round gauges (effective rank, coefficient drift) and measured
        wire bytes per direction. Read-only."""
        hub = self.telemetry
        if not hub.enabled:
            return
        r = int(res.round_idx)
        if res.ranks:
            hub.gauge(
                "rank.effective_mean",
                float(np.mean([np.mean(v) for v in res.ranks.values()])),
                round=r,
            )
        if "max_coeff_drift" in metrics:
            hub.gauge("correction.coeff_drift_max", float(metrics["max_coeff_drift"]), round=r)
        if res.wire_codec:
            hub.counter("wire.bytes_down", res.wire_bytes_down_per_client * res.cohort_size,
                        round=r, codec=res.wire_codec)
            hub.counter("wire.bytes_up", res.wire_bytes_up_per_client * res.cohort_size,
                        round=r, codec=res.wire_codec)

    # -- checkpoint / restore ----------------------------------------------

    def _ckpt_path(self, round_idx: int) -> str:
        return f"{self.checkpoint_dir}/round_{round_idx:06d}.npz"

    def _save_checkpoint(self):
        path = self._ckpt_path(self.round_idx)
        save_checkpoint(path, self.params, meta={
            "round": self.round_idx, "method": self.method, **self.checkpoint_meta,
        })
        # sidecar: the batcher's stream state (so a restored run replays the
        # remaining rounds bit-identically) and the round history (so
        # comm_total_bytes() spans the whole run), as versioned JSON-safe
        # dicts, never pickled dataclasses
        state = {"version": STATE_VERSION, "history": history_to_state(self.history)}
        if self._batcher is not None and hasattr(self._batcher, "state"):
            state["batcher"] = self._batcher.state()
        np.save(path + ".state.npy", np.asarray(state, dtype=object), allow_pickle=True)

    def restore(self, path: str, *, batcher=None) -> dict:
        """Resume from a checkpoint written by this engine or by the JAX
        package's.

        Restores ``params`` (on the device of the current ones, in their
        stored dtypes), ``round_idx`` (so participation policies, seeded by
        ``(seed, round_idx)``, replay the same cohorts) and the round
        ``history``; with ``batcher`` and the ``<path>.state.npy`` sidecar,
        also the batcher's stream state. The restored run then reproduces
        the uninterrupted one bit for bit. Returns the checkpoint metadata.
        """
        params, meta = load_checkpoint(path, device=self.device)
        self.params = params
        self.round_idx = int(meta.get("round", 0))
        state_path = path + ".state.npy"
        if os.path.exists(state_path):
            # repro-lint: disable=RPL007 -- the engine's own versioned
            # checkpoint sidecar: a STATE_VERSION-stamped dict of JSON-safe
            # values written by _save_checkpoint (np.save of an object array
            # needs allow_pickle)
            state = np.load(state_path, allow_pickle=True).item()
            if state.get("version", 0) >= 1:
                self.history = history_from_state(state.get("history", []))
            else:
                # legacy (unversioned) sidecar: pickled RoundResult objects
                self.history = list(state.get("history", []))
            if batcher is not None and "batcher" in state:
                batcher.set_state(state["batcher"])
        return meta

    def train(self, batcher, num_rounds: int, *, log_every: int = 10):
        num_clients = self.cfg.num_clients
        self._batcher = batcher
        for _ in range(num_rounds):
            cohort = self.participation.cohort(self.round_idx, num_clients)
            if self.participation.mode == "full":
                batch = batcher.next_round()
            else:
                batch = batcher.next_round(cohort)
            res = self.run_round(batch, cohort=cohort)
            if log_every and res.round_idx % log_every == 0:
                extra = ""
                if res.ranks:
                    mean_rank = np.mean([np.mean(v) for v in res.ranks.values()])
                    extra = f" mean_rank={mean_rank:.1f}"
                if res.cohort_size != num_clients:
                    extra += f" cohort={res.cohort_size}/{num_clients}"
                wire_mb = (res.wire_bytes_down_per_client + res.wire_bytes_up_per_client) / 1e6
                comm = (
                    f" wire {wire_mb:.2f} MB/client [{res.wire_codec}]"
                    if res.wire_codec
                    else f" comm {res.comm_bytes_per_client/1e6:.2f} MB/client"
                )
                self.telemetry.progress(
                    f"[{self.method}] round {res.round_idx:4d} "
                    f"loss {res.loss_before:.4f}"
                    + (f" → {res.loss_after:.4f}" if res.loss_after is not None else "")
                    + comm
                    + extra,
                    round=int(res.round_idx),
                )
        return self.history

    def evaluate(self, batch) -> float:
        assert self.eval_fn is not None
        return float(self.eval_fn(self.params, self._to_device(batch)))

    def comm_total_bytes(self) -> float:
        """Total server-side on-wire bytes so far, **measured**: each round's
        measured per-client bytes (down + up) times its active cohort. A
        round that carries no measurement (run with ``wire_codec=None``, or
        restored from a history without wire fields) contributes the
        analytic figure instead; :meth:`comm_total_bytes_analytic` is
        uniform across rounds."""
        total = 0.0
        for r in self.history:
            per_client = r.wire_bytes_down_per_client + r.wire_bytes_up_per_client
            if per_client == 0.0 and not r.wire_codec:
                per_client = r.comm_bytes_per_client  # unmetered round
            total += per_client * r.cohort_size
        return float(total)

    def comm_total_bytes_analytic(self) -> float:
        """Total bytes under the analytic cost model (static ``r_max``
        protocol volumes, :mod:`repro_torch.core.cost_model`)."""
        return float(sum(r.comm_bytes_per_client * r.cohort_size for r in self.history))


def _to_host(metrics):
    """Round metrics as python floats / numpy arrays (one sync per round)."""
    if isinstance(metrics, dict):
        return {k: _to_host(v) for k, v in metrics.items()}
    if torch.is_tensor(metrics):
        a = metrics.detach().cpu().numpy()
        return a if a.ndim else float(a)
    return metrics
