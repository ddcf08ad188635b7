"""``serve(spec) → ServeSession``: the one place the port's serving stack is
constructed (the serving half of the JAX package's ``repro.api.experiment``).
"""
from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Optional

import numpy as np
import torch

from repro_torch.api.spec import ExperimentSpec
from repro_torch.api.tasks import lm_model_config
from repro_torch.checkpoint import load_checkpoint
from repro_torch.models import build_model
from repro_torch.serve import ContinuousScheduler, Request, ServeEngine


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


def serve(spec: ExperimentSpec, *, params=None, device="cuda", telemetry=None) -> "ServeSession":
    """Resolve a spec into a running :class:`ServeSession` on ``device``.

    Params come from, in priority order: the explicit ``params`` argument,
    the checkpoint named by ``spec.serve.checkpoint`` (a ``round_*.npz``
    file written by the JAX package, or a directory whose latest round
    wins), or fresh initialization from ``spec.seed`` (smoke runs).
    """
    dev = resolve_device(device)
    cfg = lm_model_config(spec.model)
    model = build_model(cfg)
    sv = spec.serve

    if params is None:
        if sv.checkpoint is not None:
            path = sv.checkpoint
            if os.path.isdir(path):
                ckpts = sorted(glob.glob(os.path.join(path, "round_*.npz")))
                if not ckpts:
                    raise FileNotFoundError(f"no round_*.npz checkpoints under {path!r}")
                path = ckpts[-1]
            params, _meta = load_checkpoint(path, device=dev)
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(spec.seed)
            with torch.inference_mode():
                params = model.init(gen)

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
        telemetry=telemetry,
    )
    # repro-lint: disable=RPL001 -- the port's serve() seam (see above)
    scheduler = ContinuousScheduler(
        engine, max_queue=sv.max_queue, mode=sv.mode, telemetry=telemetry,
    )
    return ServeSession(spec=spec, engine=engine, scheduler=scheduler, hub=telemetry)


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
        m = s.model
        return "\n".join([
            f"serve {s.name or '(unnamed)'}  [device {self.engine.device}]",
            f"  model     {m.preset or m.arch}"
            + ("  (smoke)" if m.smoke else "")
            + (f"  layers={m.layers}" if m.layers else "")
            + (f"  dtype={m.dtype}" if m.dtype else "")
            + f"  kernels={m.kernels}",
            f"  params    {sv.checkpoint or '(fresh init)'}  quantize={sv.quantize}",
            f"  batching  {sv.mode}  slots={sv.max_batch}  queue≤{sv.max_queue}",
            f"  shapes    prompt≤{sv.max_prompt} (bucket {sv.prompt_bucket})"
            f"  decode≤{sv.max_new_tokens}  cache={sv.cache_len}",
            f"  sampling  temperature={sv.temperature:g}"
            + (f"  eos={sv.eos_id}" if sv.eos_id is not None else "")
            + f"  (seed {s.seed})",
        ])
