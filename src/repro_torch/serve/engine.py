"""Factor-resident decode engine (the JAX package's ``serve/engine.py``).

The engine owns the model, its parameters and the per-slot decode state;
the scheduler (:mod:`repro_torch.serve.scheduler`) owns request admission.
Serving runs eagerly under ``torch.inference_mode()``, in three shapes:

- **prefill per prompt-length bucket** — prompts are right-padded to the
  next multiple of ``prompt_bucket`` and run at ``B = 1``; the causal mask
  keeps pad keys out of every real query and ``last_index`` reads the true
  last-token logits, so bucketing never changes tokens;
- **insert** — copies a B=1 prefill cache into slot ``i`` of the per-slot
  batch state, in place;
- **decode** at the fixed ``(max_batch, cache_len)`` shape — every step
  decodes the full slot array; inactive slots carry garbage rows that never
  escape (the scheduler ignores them).

Every factorized matmul goes through ``apply_linear`` → ``lowrank_apply``,
so ``U S Vᵀ`` is never materialized: on a CUDA device each linear layer
and the embedding launch one ``xus`` and one ``avt`` kernel.

Sampling is deterministic and batching-invariant: token ``j`` of request
``rid`` is drawn with a ``torch.Generator`` seeded from a fixed function of
``(seed, rid, j)``, so a request's output does not depend on which other
requests share the batch. (It cannot reproduce the JAX package's threefry
draws; greedy decoding is what is held to the JAX package.)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.telemetry import NULL_HUB

_MASK64 = (1 << 64) - 1


def _mix(h: int, v: int) -> int:
    """One splitmix64 round over ``h ^ v``: a fixed, well-spread seed
    function of the request coordinates."""
    z = ((h ^ (v & _MASK64)) + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def sample_seed(seed: int, rid: int, token_idx: int) -> int:
    """The generator seed of token ``token_idx`` of request ``rid``."""
    return _mix(_mix(_mix(0, seed), max(rid, 0)), token_idx) & ((1 << 63) - 1)


def _insert_cache(state: dict, one: dict, slot: int, length: int) -> dict:
    """Graft a B=1 prefill cache into row ``slot`` of the per-slot state,
    in place.

    ``idx`` buffers are (NB, batch) write indices and ``pos`` is the
    (batch,) position vector: both are stamped with the true prompt
    ``length``, so the right-pad columns beyond it become stale cache
    entries the attention mask already rejects. Every other leaf carries
    batch on axis 1 under the (NB, ...) stack.
    """
    for k, dv in state.items():
        sv = one[k]
        if isinstance(dv, dict):
            _insert_cache(dv, sv, slot, length)
        elif k == "idx":
            dv[:, slot] = length
        elif k == "pos":
            dv[slot] = length
        else:
            dv[:, slot].copy_(sv[:, 0])
    return state


class ServeEngine:
    """Decode over one parameter tree. Construct via
    ``repro_torch.api.experiment.serve(spec)``."""

    def __init__(
        self,
        model,
        params,
        *,
        max_batch: int = 4,
        max_prompt: int = 64,
        prompt_bucket: int = 16,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        seed: int = 0,
        telemetry=None,
    ):
        if max_prompt % prompt_bucket:
            raise ValueError(
                f"prompt_bucket ({prompt_bucket}) must divide max_prompt ({max_prompt})"
            )
        self.model = model
        self.params = params
        self.device = params["final_norm"].device
        self.max_batch = int(max_batch)
        self.max_prompt = int(max_prompt)
        self.prompt_bucket = int(prompt_bucket)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.cache_len = self.max_prompt + self.max_new_tokens
        self.hub = telemetry if telemetry is not None else NULL_HUB

    # ------------------------------------------------------------- state

    def new_state(self) -> dict:
        """Fresh per-slot decode state at the (max_batch, cache_len) shape."""
        with torch.inference_mode():
            return self.model.init_cache(
                self.params, self.max_batch, self.cache_len, per_slot=True
            )

    # ----------------------------------------------------------- prefill

    def bucket_len(self, length: int) -> int:
        b = self.prompt_bucket
        return -(-length // b) * b

    def prefill(self, prompt):
        """Run one prompt through its length bucket → (logits (1, V), cache)."""
        prompt = np.asarray(prompt, np.int64).ravel()
        length = int(prompt.size)
        if length < 1:
            raise ValueError("empty prompt")
        if length > self.max_prompt:
            raise ValueError(f"prompt length {length} exceeds max_prompt={self.max_prompt}")
        tokens = np.zeros((1, self.bucket_len(length)), np.int64)
        tokens[0, :length] = prompt
        with torch.inference_mode():
            return self.model.serve_prefill(
                self.params,
                {"tokens": torch.from_numpy(tokens).to(self.device)},
                cache_len=self.cache_len,
                last_index=length - 1,
            )

    def insert(self, state, cache, slot: int, length: int):
        """Graft a B=1 prefill ``cache`` into ``state`` row ``slot``."""
        with torch.inference_mode():
            return _insert_cache(state, cache, int(slot), int(length))

    # ------------------------------------------------------------ decode

    def step(self, state, last_tokens):
        """One decode step over all slots: (B,) tokens → (logits, state)."""
        tokens = torch.from_numpy(
            np.asarray(last_tokens, np.int64).reshape(self.max_batch, 1)
        ).to(self.device)
        with torch.inference_mode():
            return self.model.serve_step(self.params, state, tokens)

    def sample(self, logits, rids, steps) -> np.ndarray:
        """Greedy at temperature 0, else a Gumbel-max draw from a generator
        seeded on (seed, rid, token index)."""
        with torch.inference_mode():
            if self.temperature <= 0.0:
                return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
            scaled = logits.float() / self.temperature
            out = []
            for row, rid, step in zip(scaled, np.asarray(rids), np.asarray(steps)):
                gen = torch.Generator(device=row.device)
                gen.manual_seed(sample_seed(self.seed, int(rid), int(step)))
                u = torch.rand(row.shape, generator=gen, device=row.device)
                u = u.clamp_(min=torch.finfo(torch.float32).tiny)
                out.append(torch.argmax(row - torch.log(-torch.log(u))))
            return torch.stack(out).to(torch.int32).cpu().numpy()
