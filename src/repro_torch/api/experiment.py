"""``build(spec) → Experiment`` and ``serve(spec) → ServeSession``: the one
place the port's training engine and serving stack are constructed (the
JAX package's ``repro.api.experiment``).

Both run on the card (``device="cuda"``) unless the caller asks for the
CPU; asking for CUDA without a card raises. Both install the spec's
telemetry hub as the process-global one (``set_hub``), as the JAX package
does. A non-sync engine or a ``sim.profile`` goes to the system simulator
(:func:`repro_torch.fed.sim.make_sim_engine`), the plain synchronous
engine otherwise.
"""
from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Optional

import numpy as np
import torch

from repro_torch.api.spec import ExperimentSpec
from repro_torch.api.tasks import Task, build_task, lm_model_config
from repro_torch.checkpoint import load_checkpoint, load_checkpoint_meta
from repro_torch.fed.engine import FederatedEngine
from repro_torch.fed.sim import make_sim_engine
from repro_torch.models import build_model
from repro_torch.serve import ContinuousScheduler, Request, ServeEngine
from repro_torch.serve.quantize import materialize_params, quantize_params, rank_slice_params
from repro_torch.telemetry import hub_from_spec, set_hub
from repro_torch.utils.tree import tree_map


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA unless the caller asks for
    the CPU; asking for CUDA without one is an error, never a quiet fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' (--device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on cuda or cpu, got {device!r}")
    return dev


def _latest_checkpoint(directory: str) -> str:
    """The last ``round_*.npz`` under ``directory`` (round numbers are
    zero-padded, so the names sort by round)."""
    ckpts = sorted(glob.glob(os.path.join(directory, "round_*.npz")))
    if not ckpts:
        raise FileNotFoundError(f"no round_*.npz checkpoints under {directory!r}")
    return ckpts[-1]


def _spec_hub(spec: ExperimentSpec, telemetry):
    """The run's hub: ``telemetry`` if given, else the spec's; installed as
    the process-global hub (kernel dispatch counters read it)."""
    hub = telemetry if telemetry is not None else hub_from_spec(
        spec.telemetry, meta={"spec_hash": spec.spec_hash(), "spec_name": spec.name},
    )
    set_hub(hub)
    return hub


def build(spec: ExperimentSpec, *, params=None, device="cuda", telemetry=None) -> "Experiment":
    """Resolve a validated spec into a runnable :class:`Experiment` on
    ``device``. ``params`` (optional) replaces the task's fresh
    initialization, e.g. parameters carried over from the JAX package by
    :func:`repro_torch.checkpoint.params_from_numpy`; they are moved to
    ``device``. ``telemetry`` (a hub) replaces the spec's telemetry section."""
    dev = resolve_device(device)
    hub = _spec_hub(spec, telemetry)
    task = build_task(spec, dev)
    if params is not None:
        task = dataclasses.replace(task, params=tree_map(lambda t: t.to(dev), params))
    fc = spec.fed.to_fed_config()
    participation = spec.participation.build(seed=spec.seed)
    client_weights = task.client_sizes if spec.fed.weighted else None
    ckpt_meta = {"spec_hash": spec.spec_hash()}
    if spec.name:
        ckpt_meta["spec_name"] = spec.name
    if spec.engine.kind != "sync" or spec.sim.profile is not None:
        # participation and checkpointing always pass through: engines
        # that cannot honour them refuse instead of dropping them
        kw = dict(
            sim_profile=spec.sim.profile,
            seed=spec.seed,
            method=spec.fed.method,
            wire_codec=spec.wire.codec,
            client_weights=client_weights,
            participation=participation,
            checkpoint_dir=spec.checkpoint.dir,
            checkpoint_every=spec.checkpoint.effective_every,
            checkpoint_meta=ckpt_meta,
            telemetry=hub,
        )
        # None = unset: make_sim_engine's own defaults apply
        if spec.engine.kind == "async":
            kw["buffer_size"] = spec.engine.buffer_size
            if spec.engine.staleness_power is not None:
                kw["staleness_power"] = spec.engine.staleness_power
        elif spec.engine.kind == "hier":
            kw["edge_wire_codec"] = spec.wire.edge_codec
            if spec.engine.edges is not None:
                kw["num_edges"] = spec.engine.edges
            if spec.engine.edge_rounds is not None:
                kw["edge_rounds"] = spec.engine.edge_rounds
        # repro-lint: disable=RPL001 -- the port's build() seam (see below)
        engine = make_sim_engine(spec.engine.kind, task.loss_fn, task.params, fc, **kw)
    else:
        # repro-lint: disable=RPL001 -- this is the port's build() seam, the
        # twin of repro.api.experiment.build(); the lint's path rules only
        # know the JAX package's own tree, so the sanctioned home needs
        # saying here
        engine = FederatedEngine(
            task.loss_fn, task.params, fc,
            method=spec.fed.method,
            participation=participation,
            client_weights=client_weights,
            checkpoint_dir=spec.checkpoint.dir,
            checkpoint_every=spec.checkpoint.effective_every,
            wire_codec=spec.wire.codec,
            checkpoint_meta=ckpt_meta,
            telemetry=hub,
        )
    return Experiment(spec=spec, task=task, engine=engine, hub=hub)


@dataclasses.dataclass
class Experiment:
    """A built experiment: spec + task + engine, ready to run.

    ``run()`` trains ``spec.rounds`` rounds (overridable) and returns the
    engine's round history; ``resume()`` restores the latest (or a named)
    checkpoint after checking its spec hash; ``evaluate()`` is the task's
    holdout metric; ``describe()`` renders the scenario for humans.
    """

    spec: ExperimentSpec
    task: Task
    engine: object  # a FederatedEngine, or one of repro_torch.fed.sim's engines
    hub: Optional[object] = None

    @property
    def params(self):
        return self.engine.params

    @property
    def history(self) -> List:
        return self.engine.history

    @property
    def is_simulated(self) -> bool:
        """True when rounds are priced on a virtual clock (any non-sync
        engine, or a sync engine with a fleet profile)."""
        return self.spec.engine.kind != "sync" or self.spec.sim.profile is not None

    def run(self, rounds: Optional[int] = None, *, log_every: Optional[int] = None):
        """Train ``rounds`` (default ``spec.rounds``) aggregation rounds."""
        n = self.spec.rounds if rounds is None else rounds
        le = self.spec.log_every if log_every is None else log_every
        try:
            return self.engine.train(self.task.batcher, n, log_every=le)
        finally:
            if self.hub is not None:
                self.hub.flush()

    def evaluate(self) -> float:
        """The task's holdout metric (accuracy) on the current params."""
        if self.task.eval_fn is None:
            raise ValueError(f"the {self.spec.model.kind!r} task defines no holdout eval")
        return self.task.eval_fn(self.engine.params)

    def resume(self, path: Optional[str] = None) -> dict:
        """Restore a checkpoint written by this spec's engine, in either
        package (their spec hashes agree).

        ``path`` defaults to the latest ``round_*.npz`` under
        ``spec.checkpoint.dir``. A checkpoint stamped with a *different*
        spec hash is refused before any state is touched: resuming under
        changed hyperparameters would silently corrupt the run.
        """
        if not hasattr(self.engine, "restore"):
            raise ValueError(f"the {self.spec.engine.kind} engine does not support resume")
        if path is None:
            if not self.spec.checkpoint.dir:
                raise ValueError("resume() needs checkpoint.dir in the spec or an explicit path")
            path = _latest_checkpoint(self.spec.checkpoint.dir)
        stamped = load_checkpoint_meta(path).get("spec_hash")
        ours = self.spec.spec_hash()
        if stamped is not None and stamped != ours:
            raise ValueError(
                f"checkpoint {path!r} was written by spec {stamped}, but this experiment is "
                f"spec {ours}; refusing to resume a mismatched spec (same seed is not the "
                f"same run under different hyperparameters)"
            )
        return self.engine.restore(path, batcher=self.task.batcher)

    def comm_total_bytes(self) -> float:
        return self.engine.comm_total_bytes()

    def serve(self) -> "ServeSession":
        """Serve this experiment's current params in-process, on its device
        and hub (the spec's ``serve.checkpoint`` is ignored; everything
        else applies)."""
        return serve(self.spec, params=self.engine.params, device=self.engine.device,
                     telemetry=self.hub)

    def describe(self) -> str:
        s = self.spec
        eng = s.engine.kind
        # unset (None) knobs stay with the engine factory's defaults; only
        # what the spec pins is reported
        if eng == "async":
            knobs = [
                f"buffer_size={s.engine.buffer_size}"
                if s.engine.buffer_size is not None
                else f"buffer_size={s.fed.clients} (cohort)",
            ]
            if s.engine.staleness_power is not None:
                knobs.append(f"staleness_power={s.engine.staleness_power:g}")
            eng += f" ({', '.join(knobs)})"
        elif eng == "hier":
            knobs = []
            if s.engine.edges is not None:
                knobs.append(f"edges={s.engine.edges}")
            if s.engine.edge_rounds is not None:
                knobs.append(f"edge_rounds={s.engine.edge_rounds}")
            if knobs:
                eng += f" ({', '.join(knobs)})"
        wire = s.wire.codec
        if s.wire.edge_codec is not None:
            wire += f" (edge: {s.wire.edge_codec})"
        ckpt = (
            f"{s.checkpoint.dir} every {s.checkpoint.effective_every}"
            if s.checkpoint.dir else "(off)"
        )
        tel = (
            f"{s.telemetry.sinks}"
            + (f" → {s.telemetry.dir}" if s.telemetry.dir else "")
            + (f" (every {s.telemetry.sample_every} rounds)"
               if s.telemetry.sample_every > 1 else "")
            if s.telemetry.enabled else "(off)"
        )
        srv = s.serve
        srv_line = f"{srv.mode}  batch={srv.max_batch}  cache={srv.max_prompt}+{srv.max_new_tokens}"
        if srv.quantize != "none":
            srv_line += f"  quantize={srv.quantize}"
        if srv.rank_slice:
            srv_line += "  rank_slice"
        if srv.materialize:
            srv_line += "  materialize"
        return "\n".join([
            f"experiment {s.name or '(unnamed)'}  [spec {s.spec_hash()}]  "
            f"[device {self.engine.device}]",
            f"  task           {s.model.kind}: {self.task.description}"
            + f"  kernels={s.model.kernels}",
            f"  fed            {s.fed.method}"
            + (f"/{s.fed.correction_effective}" if s.fed.method.startswith("fedlrt") else "")
            + f"  C={s.fed.clients}  s*={s.fed.s_star}  lr={s.fed.lr:g}  tau={s.fed.tau:g}"
            + ("  weighted" if s.fed.weighted else ""),
            f"  participation  {s.participation.to_string()}",
            f"  engine         {eng}",
            f"  wire           {wire}",
            f"  sim            {s.sim.profile or '(no virtual clock)'}",
            f"  checkpoint     {ckpt}",
            f"  telemetry      {tel}",
            f"  serve          {srv_line}",
            f"  data           batch={s.data.batch}"
            + (f"  seq={s.data.seq}" if s.model.kind == "lm" else "")
            + f"  partition={s.data.partition}",
            f"  rounds         {s.rounds}  (seed {s.seed})",
        ])


def serve(spec: ExperimentSpec, *, params=None, device="cuda", telemetry=None) -> "ServeSession":
    """Resolve a spec into a running :class:`ServeSession` on ``device``.

    Params come from, in priority order: the explicit ``params`` argument,
    the checkpoint named by ``spec.serve.checkpoint`` (a ``round_*.npz``
    file written by either package's engine, or a directory whose latest
    round wins), or fresh initialization from ``spec.seed`` (smoke runs).
    Then the at-rest transforms: rank slicing first (smaller buffers to
    compress), then materialization, else quantization; ``ServeSpec``
    refuses the combinations that do not compose. ``telemetry`` (a hub)
    replaces the spec's telemetry section.
    """
    if spec.model.kind != "lm":
        raise ValueError(
            f"serving decodes tokens; model.kind={spec.model.kind!r} has no "
            f"decode path (use kind='lm')"
        )
    dev = resolve_device(device)
    hub = _spec_hub(spec, telemetry)
    cfg = lm_model_config(spec.model)
    model = build_model(cfg)
    sv = spec.serve

    if params is None:
        if sv.checkpoint is not None:
            path = sv.checkpoint
            if os.path.isdir(path):
                path = _latest_checkpoint(path)
            params, _meta = load_checkpoint(path, device=dev)
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(spec.seed)
            with torch.inference_mode():
                params, _ = model.init(gen)

    with torch.inference_mode():
        if sv.rank_slice:
            params = rank_slice_params(params)
        if sv.materialize:
            params = materialize_params(params)
        elif sv.quantize != "none":
            params = quantize_params(params, sv.quantize)

    # repro-lint: disable=RPL001 -- this is the port's serve() seam, the
    # twin of repro.api.experiment.serve(); the lint's path rules only know
    # the JAX package's own tree, so the sanctioned home needs saying here
    engine = ServeEngine(
        model, params,
        max_batch=sv.max_batch,
        max_prompt=sv.max_prompt,
        prompt_bucket=sv.prompt_bucket,
        max_new_tokens=sv.max_new_tokens,
        temperature=sv.temperature,
        seed=spec.seed,
        telemetry=hub,
    )
    # repro-lint: disable=RPL001 -- the port's serve() seam (see above)
    scheduler = ContinuousScheduler(
        engine, max_queue=sv.max_queue, mode=sv.mode, telemetry=hub,
    )
    return ServeSession(spec=spec, engine=engine, scheduler=scheduler, hub=hub)


@dataclasses.dataclass
class ServeSession:
    """A built serving stack: spec + engine + scheduler.

    ``submit``/``run`` forward to the scheduler; ``generate`` serves a list
    of prompts and returns the generated token arrays with the per-request
    :class:`~repro_torch.serve.Completion` stats.
    """

    spec: ExperimentSpec
    engine: ServeEngine
    scheduler: ContinuousScheduler
    hub: Optional[object] = None

    def submit(self, request) -> None:
        self.scheduler.submit(request)

    def run(self, requests) -> List:
        try:
            return self.scheduler.run(requests)
        finally:
            if self.hub is not None:
                self.hub.flush()

    def generate(self, prompts, *, max_new_tokens=None, arrival_steps=None):
        """Serve a list of 1-D token prompts; returns ``(outputs,
        completions)`` with outputs ordered like ``prompts``."""
        sv = self.spec.serve
        arrivals = arrival_steps or [0] * len(prompts)
        reqs = [
            Request(
                rid=i,
                tokens=np.asarray(p, np.int32),
                max_new_tokens=max_new_tokens,
                eos_id=sv.eos_id,
                arrival_step=int(step),
            )
            for i, (p, step) in enumerate(zip(prompts, arrivals))
        ]
        comps = self.run(reqs)
        return [c.tokens for c in comps], comps

    def describe(self) -> str:
        s, sv = self.spec, self.spec.serve
        m, cfg = s.model, self.engine.model.cfg
        return "\n".join([
            f"serve {s.name or '(unnamed)'}  [spec {s.spec_hash()}]  "
            f"[device {self.engine.device}]",
            f"  model     {m.preset or m.arch}"
            + ("  (smoke)" if m.smoke else "")
            + f"  layers={cfg.num_layers}  dtype={cfg.compute_dtype}"
            + f"  kernels={m.kernels}",
            f"  params    {sv.checkpoint or '(fresh init)'}  quantize="
            + ("materialized-dense" if sv.materialize else sv.quantize)
            + ("  rank_slice" if sv.rank_slice else ""),
            f"  batching  {sv.mode}  slots={sv.max_batch}  queue≤{sv.max_queue}",
            f"  shapes    prompt≤{sv.max_prompt} (bucket {sv.prompt_bucket})"
            f"  decode≤{sv.max_new_tokens}  cache={sv.cache_len}",
            f"  sampling  temperature={sv.temperature:g}"
            + (f"  eos={sv.eos_id}" if sv.eos_id is not None else "")
            + f"  (seed {s.seed})",
        ])
