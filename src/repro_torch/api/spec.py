"""The serving part of the experiment spec: what is served, and how.

The port's subset of the JAX package's ``repro.api.spec``: a
:class:`ModelSpec` (the ``lm`` task's preset or architecture), a
:class:`ServeSpec` and the :class:`ExperimentSpec` that holds them with a
name and a seed. Field names, defaults and validation follow the JAX
package; the full spec (federated training, data, wire, sim, TOML files)
comes with the training slice (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from dataclasses import field
from typing import Optional

from repro_torch.kernels.ops import use_kernels_for
from repro_torch.serve.scheduler import SCHED_MODES

#: at-rest factor formats the port serves (int8 / bf16 come with
#: serve/quantize.py, ROADMAP.md queue 1)
QUANT_MODES = ("none",)
DTYPES = ("", "float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """What is served: a decoder LM from a named ``preset`` *or* an
    architecture registry ``arch`` (exactly one).

    ``layers`` > 0 cuts the architecture's depth to that many layers and
    ``dtype`` ("float32" / "bfloat16") overrides its compute and parameter
    dtypes; both are for smoke runs at full width.
    """

    kind: str = "lm"
    preset: Optional[str] = None
    arch: Optional[str] = None
    smoke: bool = False
    kernels: str = "auto"
    layers: int = 0
    dtype: str = ""

    def __post_init__(self):
        if self.kind != "lm":
            raise ValueError(
                f"model.kind={self.kind!r}: the port serves the 'lm' task only "
                f"(the other tasks come with the training slice, ROADMAP.md)"
            )
        if (self.preset is None) == (self.arch is None):
            raise ValueError("model: set exactly one of preset / arch")
        use_kernels_for(self.kernels)  # parse = validate
        if self.layers < 0:
            raise ValueError("model.layers must be >= 0 (0 keeps the depth)")
        if self.dtype not in DTYPES:
            raise ValueError(f"model.dtype must be one of {DTYPES}, got {self.dtype!r}")


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """How the factorized model is served (:mod:`repro_torch.serve`).

    ``checkpoint`` names a ``round_*.npz`` file or a checkpoint directory
    (latest round wins); ``None`` serves fresh seed-initialized params.
    ``mode`` selects continuous batching or the static-wave baseline.
    Prompts are right-padded to ``prompt_bucket`` multiples, and decode runs
    at ``(max_batch, max_prompt + max_new_tokens)``.
    """

    checkpoint: Optional[str] = None
    quantize: str = "none"
    mode: str = "continuous"
    max_batch: int = 4
    max_queue: int = 64
    max_prompt: int = 64
    prompt_bucket: int = 16
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: Optional[int] = None

    def __post_init__(self):
        if self.quantize not in QUANT_MODES:
            raise ValueError(
                f"serve.quantize={self.quantize!r} is not ported yet (the port "
                f"serves {QUANT_MODES}; see ROADMAP.md, queue 1)"
            )
        if self.mode not in SCHED_MODES:
            raise ValueError(f"serve.mode must be one of {SCHED_MODES}, got {self.mode!r}")
        for name in ("max_batch", "max_queue", "max_prompt", "prompt_bucket", "max_new_tokens"):
            if getattr(self, name) < 1:
                raise ValueError(f"serve.{name} must be >= 1")
        if self.max_queue < self.max_batch:
            raise ValueError(
                f"serve.max_queue ({self.max_queue}) must hold at least one "
                f"full slot cohort (serve.max_batch={self.max_batch})"
            )
        if self.max_prompt % self.prompt_bucket:
            raise ValueError(
                f"serve.prompt_bucket ({self.prompt_bucket}) must divide "
                f"serve.max_prompt ({self.max_prompt})"
            )
        if self.temperature < 0:
            raise ValueError("serve.temperature must be >= 0")
        if self.eos_id is not None and self.eos_id < 0:
            raise ValueError("serve.eos_id must be a token id (>= 0)")

    @property
    def cache_len(self) -> int:
        """Per-slot KV budget: longest admissible prompt + decode room."""
        return self.max_prompt + self.max_new_tokens


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """A named, seeded serving scenario."""

    name: str = ""
    seed: int = 0
    model: ModelSpec = field(default_factory=lambda: ModelSpec(preset="llm-tiny"))
    serve: ServeSpec = field(default_factory=ServeSpec)
