"""Continuous-batching scheduler: request queue → decode slots → completions.

The JAX package's ``serve/scheduler.py``, unchanged in behaviour. Each
:meth:`ContinuousScheduler.step` runs ONE decode step of the engine at its
fixed ``(max_batch, cache_len)`` shape and, in ``"continuous"`` mode,
first admits queued requests into any freed slots (B=1 prefill at the
prompt's bucket, grafted into the slot by the engine's insert).
``"static"`` mode is the legacy baseline the bench compares against: a new
wave is admitted only when *every* slot is free, so the whole batch waits
for its slowest member.

Determinism: admission order is queue order (FIFO), slot choice is lowest
free index, and sampling is keyed on (seed, rid, token index) in the
engine — so for a fixed arrival trace the token streams are reproducible
and independent of batching mode.  All host timing goes through
``repro_torch.telemetry.clock.perf_seconds``.

Telemetry per request: a ``serve.queued`` wall span (submit→admit), a
``serve.prefill`` span, a ``serve.decode`` wall span (admit→finish),
``serve.tokens`` counters and ``serve.queue_depth`` / ``serve.active``
gauges.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np

from repro_torch.telemetry import NULL_HUB
from repro_torch.telemetry.clock import perf_seconds

SCHED_MODES = ("continuous", "static")


@dataclasses.dataclass
class Request:
    """One generation request.  ``arrival_step`` is the decode-step index
    at which :meth:`ContinuousScheduler.run` makes it visible — the seeded
    Poisson trace in the bench is a list of these."""

    rid: int
    tokens: np.ndarray  # 1-D int32 prompt
    max_new_tokens: Optional[int] = None  # None → engine default
    eos_id: Optional[int] = None
    arrival_step: int = 0


@dataclasses.dataclass
class Completion:
    """A finished request with its phase timings (wall seconds)."""

    rid: int
    prompt_len: int
    tokens: np.ndarray  # generated tokens, eos included when hit
    submit_step: int
    admit_step: int
    finish_step: int
    queued_s: float
    prefill_s: float
    decode_s: float

    @property
    def tokens_per_s(self) -> float:
        return len(self.tokens) / max(self.decode_s + self.prefill_s, 1e-9)


@dataclasses.dataclass
class _Slot:
    rid: int
    prompt_len: int
    budget: int
    eos_id: Optional[int]
    out: List[int]
    t_submit: float
    t_admit: float
    prefill_s: float
    submit_step: int
    admit_step: int


class ContinuousScheduler:
    """Drive a :class:`repro_torch.serve.engine.ServeEngine` over a request
    stream.  Construct via ``repro_torch.api.experiment.serve(spec)``."""

    def __init__(self, engine, *, max_queue: int = 64,
                 mode: str = "continuous", telemetry=None):
        if mode not in SCHED_MODES:
            raise ValueError(f"mode must be one of {SCHED_MODES}, got {mode!r}")
        self.engine = engine
        self.max_queue = int(max_queue)
        self.mode = mode
        self.hub = telemetry if telemetry is not None else NULL_HUB
        self.queue: deque = deque()  # (Request, t_submit, submit_step)
        self.slots: List[Optional[_Slot]] = [None] * engine.max_batch
        self.state = engine.new_state()
        self._last = np.zeros(engine.max_batch, np.int32)
        self._rids = np.full(engine.max_batch, -1, np.int32)
        self._tok_idx = np.zeros(engine.max_batch, np.int32)
        self.step_count = 0
        self.decode_steps = 0  # steps that actually ran the decode

    # ---------------------------------------------------------- admission

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    def submit(self, req: Request) -> None:
        """Enqueue; raises ``RuntimeError`` when the queue is at capacity
        (backpressure is the caller's problem, not silent drops)."""
        if len(self.queue) >= self.max_queue:
            raise RuntimeError(
                f"serve queue full (max_queue={self.max_queue}); "
                f"apply backpressure upstream"
            )
        self.queue.append((req, perf_seconds(), self.step_count))
        self.hub.gauge("serve.queue_depth", len(self.queue))

    def _budget(self, req: Request) -> int:
        cap = self.engine.max_new_tokens
        want = cap if req.max_new_tokens is None else req.max_new_tokens
        return max(1, min(want, cap))

    def _admit(self, slot_i: int, req: Request, t_submit: float,
               submit_step: int) -> Optional[Completion]:
        t_admit = perf_seconds()
        with self.hub.span("serve.prefill", rid=req.rid):
            logits, cache = self.engine.prefill(req.tokens)
        prefill_s = perf_seconds() - t_admit
        first = int(
            self.engine.sample(logits, np.int32([req.rid]), np.int32([0]))[0]
        )
        slot = _Slot(
            rid=req.rid, prompt_len=int(np.asarray(req.tokens).size),
            budget=self._budget(req), eos_id=req.eos_id, out=[first],
            t_submit=t_submit, t_admit=t_admit, prefill_s=prefill_s,
            submit_step=submit_step, admit_step=self.step_count,
        )
        if len(slot.out) >= slot.budget or first == slot.eos_id:
            return self._complete(slot)  # done at prefill; slot never bound
        self.state = self.engine.insert(
            self.state, cache, slot_i, slot.prompt_len
        )
        self.slots[slot_i] = slot
        self._last[slot_i] = first
        self._rids[slot_i] = req.rid
        self._tok_idx[slot_i] = 1
        return None

    def _complete(self, slot: _Slot) -> Completion:
        t_end = perf_seconds()
        self.hub.span_wall_at(
            "serve.queued", slot.t_submit, slot.t_admit, rid=slot.rid
        )
        self.hub.span_wall_at(
            "serve.decode", slot.t_admit + slot.prefill_s, t_end,
            rid=slot.rid, tokens=len(slot.out),
        )
        self.hub.counter("serve.tokens", len(slot.out))
        self.hub.counter("serve.requests_completed")
        return Completion(
            rid=slot.rid, prompt_len=slot.prompt_len,
            tokens=np.asarray(slot.out, np.int32),
            submit_step=slot.submit_step, admit_step=slot.admit_step,
            finish_step=self.step_count,
            queued_s=slot.t_admit - slot.t_submit,
            prefill_s=slot.prefill_s,
            decode_s=t_end - (slot.t_admit + slot.prefill_s),
        )

    # --------------------------------------------------------------- step

    def step(self) -> List[Completion]:
        """Admit (mode-dependent) + one decode step; returns completions."""
        done: List[Completion] = []
        may_admit = self.mode == "continuous" or self.active == 0
        if may_admit:
            for i, s in enumerate(self.slots):
                if not self.queue:
                    break
                if s is None:
                    req, t_submit, submit_step = self.queue.popleft()
                    c = self._admit(i, req, t_submit, submit_step)
                    if c is not None:
                        done.append(c)
            self.hub.gauge("serve.queue_depth", len(self.queue))

        if self.active:
            logits, self.state = self.engine.step(self.state, self._last)
            nxt = self.engine.sample(logits, self._rids, self._tok_idx)
            self.decode_steps += 1
            for i, s in enumerate(self.slots):
                if s is None:
                    continue
                tok = int(nxt[i])
                s.out.append(tok)
                self._last[i] = tok
                self._tok_idx[i] += 1
                if len(s.out) >= s.budget or tok == s.eos_id:
                    done.append(self._complete(s))
                    self.slots[i] = None
                    self._rids[i] = -1
        self.step_count += 1
        self.hub.gauge("serve.active", self.active)
        return done

    # ---------------------------------------------------------------- run

    def run(self, requests) -> List[Completion]:
        """Drive an arrival trace to completion; returns completions
        ordered by rid.  Requests become visible at their ``arrival_step``
        (in decode-step units — deterministic, unlike wall-clock gating)."""
        pending = deque(
            sorted(requests, key=lambda r: (r.arrival_step, r.rid))
        )
        done: List[Completion] = []
        while pending or self.queue or self.active:
            if (
                pending and not self.queue and not self.active
                and pending[0].arrival_step > self.step_count
            ):
                self.step_count = pending[0].arrival_step  # idle fast-forward
            while pending and pending[0].arrival_step <= self.step_count:
                self.submit(pending.popleft())
            done.extend(self.step())
        return sorted(done, key=lambda c: c.rid)
