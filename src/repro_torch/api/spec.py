"""The experiment spec: what trains or is served, on what data, and how.

The port's part of the JAX package's ``repro.api.spec``: :class:`ModelSpec`
(the ``lm``, ``mlp`` and ``lsq`` tasks), :class:`DataSpec`,
:class:`FedSpec`, :class:`ParticipationSpec`, :class:`EngineSpec` (the
synchronous engine), :class:`ServeSpec` and the :class:`ExperimentSpec`
that holds them. Field names, defaults and validation follow the JAX
package. Not ported yet (ROADMAP.md): the wire, sim, checkpoint and
telemetry sections, TOML / JSON files and the spec hash.
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
CORRECTIONS = ("auto", "none", "simplified", "full")
#: engine kinds the port runs (the JAX package also has "async" and "hier")
ENGINE_KINDS = ("sync",)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to PyTorch yet; see ROADMAP.md")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """What trains or is served: a task family plus its model knobs.

    ``kind`` selects a registered task (:mod:`repro_torch.api.tasks`):
    ``"lm"``, a decoder LM from a named ``preset`` *or* an architecture
    registry ``arch`` (exactly one); ``"mlp"``, the fig-5-style CV proxy
    head with a FeDLRT-factorized hidden layer; ``"lsq"``, the paper's
    §5.1 least-squares problem.

    ``layers`` > 0 cuts an lm architecture's depth to that many layers and
    ``dtype`` ("float32" / "bfloat16") overrides its compute and parameter
    dtypes; both are for smoke runs at full width.
    """

    kind: str = "lm"
    # lm task: exactly one of preset / arch
    preset: Optional[str] = None
    arch: Optional[str] = None
    smoke: bool = False
    kernels: str = "auto"
    layers: int = 0
    dtype: str = ""
    # mlp / lsq tasks
    dim: int = 64
    classes: int = 10
    hidden: int = 256
    r_max: int = 24
    lowrank: bool = True

    def __post_init__(self):
        use_kernels_for(self.kernels)  # parse = validate
        for f_ in ("dim", "classes", "hidden", "r_max"):
            if getattr(self, f_) <= 0:
                raise ValueError(f"model.{f_} must be positive")
        if self.kind == "lm" and (self.preset is None) == (self.arch is None):
            raise ValueError("model: the lm task needs exactly one of preset / arch")
        if self.layers < 0:
            raise ValueError("model.layers must be >= 0 (0 keeps the depth)")
        if self.dtype not in DTYPES:
            raise ValueError(f"model.dtype must be one of {DTYPES}, got {self.dtype!r}")


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """The federated data pipeline feeding the task."""

    kind: str = "token_stream"  # "token_stream" (lm) | "classification" (mlp) | "lsq"
    batch: int = 4
    partition: str = "iid"  # "iid" | "dirichlet:ALPHA"
    # token_stream
    seq: int = 128
    tokens_per_client: int = 200_000
    stream_rank: int = 16
    # classification
    num_points: int = 12_288
    noise: float = 0.3
    planted_rank: int = 6
    holdout: int = 2048  # tail points reserved for the accuracy eval

    def __post_init__(self):
        for f_ in ("batch", "seq", "tokens_per_client", "stream_rank",
                   "num_points", "planted_rank"):
            if getattr(self, f_) <= 0:
                raise ValueError(f"data.{f_} must be positive")
        if self.holdout < 0:
            raise ValueError("data.holdout must be >= 0")
        if self.holdout >= self.num_points:
            raise ValueError(
                f"data.holdout ({self.holdout}) must leave training points "
                f"(num_points={self.num_points})"
            )
        self.partition_alpha()  # parse = validate

    def partition_alpha(self) -> Optional[float]:
        """Dirichlet α of the partition spec (None for iid)."""
        kind, _, arg = self.partition.partition(":")
        if kind == "iid":
            if arg:
                raise ValueError(
                    f"data.partition 'iid' takes no argument, got {self.partition!r}"
                )
            return None
        if kind == "dirichlet":
            try:
                alpha = float(arg)
            except ValueError:
                alpha = -1.0
            if alpha <= 0:
                raise ValueError(
                    f"data.partition 'dirichlet:ALPHA' needs ALPHA > 0, "
                    f"got {self.partition!r}"
                )
            return alpha
        raise ValueError(
            f"data.partition must be 'iid' or 'dirichlet:ALPHA', got {self.partition!r}"
        )


@dataclasses.dataclass(frozen=True)
class FedSpec:
    """The federated optimization: method × correction × cohort shape.

    ``local_steps=0`` means the fig-5 scaling ``s* = max(240 // clients, 1)``.
    ``correction="auto"`` resolves to FeDLRT's ``simplified`` for
    ``method="fedlrt"`` and ``none`` for everything else; an explicit FeDLRT
    correction on a dense method is rejected.
    """

    method: str = "fedlrt"
    correction: str = "auto"
    clients: int = 4
    local_steps: int = 4
    lr: float = 3e-2
    tau: float = 0.05
    weighted: bool = False
    eval_after: bool = True

    def __post_init__(self):
        if self.correction not in CORRECTIONS:
            raise ValueError(
                f"fed.correction must be one of {CORRECTIONS}, got {self.correction!r}"
            )
        if not self.method.startswith("fedlrt") and self.correction not in ("auto", "none"):
            raise ValueError(
                f"fed.correction={self.correction!r} is a FeDLRT variance "
                f"correction; method {self.method!r} must use correction='none'"
            )
        if self.clients <= 0:
            raise ValueError(f"fed.clients must be positive, got {self.clients}")
        if self.local_steps < 0:
            raise ValueError("fed.local_steps must be >= 0 (0 = the 240/C auto scaling)")
        if self.lr <= 0:
            raise ValueError(f"fed.lr must be positive, got {self.lr}")
        if not 0.0 <= self.tau < 1.0:
            raise ValueError(f"fed.tau must lie in [0, 1), got {self.tau}")

    @property
    def s_star(self) -> int:
        return self.local_steps if self.local_steps > 0 else max(240 // self.clients, 1)

    @property
    def correction_effective(self) -> str:
        if self.correction != "auto":
            return self.correction
        return "simplified" if self.method == "fedlrt" else "none"

    def to_fed_config(self):
        from repro_torch.core.round import FedConfig

        return FedConfig(
            num_clients=self.clients,
            s_star=self.s_star,
            lr=self.lr,
            correction=self.correction_effective,
            tau=self.tau,
            eval_after=self.eval_after,
        )


@dataclasses.dataclass(frozen=True)
class ParticipationSpec:
    """Per-round cohort policy (mirrors
    :class:`~repro_torch.fed.participation.Participation`; the run seed is
    injected at build time)."""

    mode: str = "full"
    cohort_size: Optional[int] = None
    dropout_prob: float = 0.0
    min_cohort: int = 1

    def __post_init__(self):
        self.build(seed=0)  # constructing the policy = validating the spec

    @classmethod
    def from_string(cls, spec: str) -> "ParticipationSpec":
        """CLI alias: ``full`` | ``uniform:K`` | ``round_robin:K`` | ``dropout:P``."""
        from repro_torch.fed.participation import Participation

        p = Participation.from_spec(spec)
        return cls(mode=p.mode, cohort_size=p.cohort_size,
                   dropout_prob=p.dropout_prob, min_cohort=p.min_cohort)

    def to_string(self) -> str:
        if self.mode in ("uniform", "round_robin"):
            return f"{self.mode}:{self.cohort_size}"
        if self.mode == "dropout":
            return f"dropout:{self.dropout_prob:g}"
        return self.mode

    def build(self, *, seed: int):
        from repro_torch.fed.participation import Participation

        return Participation(mode=self.mode, cohort_size=self.cohort_size,
                             dropout_prob=self.dropout_prob, min_cohort=self.min_cohort,
                             seed=seed)


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """When the server aggregates: the port runs the synchronous engine
    (one barrier per round); the async and hierarchical engines are not
    ported yet."""

    kind: str = "sync"

    def __post_init__(self):
        if self.kind in ("async", "hier"):
            raise _not_ported(f"the {self.kind} engine")
        if self.kind not in ENGINE_KINDS:
            raise ValueError(f"engine.kind must be one of {ENGINE_KINDS}, got {self.kind!r}")


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
    """One FeDLRT scenario, declaratively: ``build(spec)`` turns it into a
    runnable training experiment, ``serve(spec)`` into a serving session."""

    name: str = ""
    seed: int = 0
    rounds: int = 40
    log_every: int = 5
    model: ModelSpec = field(default_factory=lambda: ModelSpec(preset="llm-tiny"))
    data: DataSpec = field(default_factory=DataSpec)
    fed: FedSpec = field(default_factory=FedSpec)
    participation: ParticipationSpec = field(default_factory=ParticipationSpec)
    engine: EngineSpec = field(default_factory=EngineSpec)
    serve: ServeSpec = field(default_factory=ServeSpec)

    def __post_init__(self):
        if self.rounds < 0:
            raise ValueError("rounds must be >= 0")
        if self.log_every < 0:
            raise ValueError("log_every must be >= 0")
        self._validate_task()
        self._validate_method()
        self._validate_cross()

    def _validate_task(self):
        from repro_torch.api.tasks import PRESETS, task_data_kinds

        data_kinds = task_data_kinds(self.model.kind)  # unknown kind raises
        if self.data.kind not in data_kinds:
            raise ValueError(
                f"data.kind={self.data.kind!r} does not feed the "
                f"{self.model.kind!r} task (expected one of {data_kinds})"
            )
        if self.model.kind == "lm" and self.model.preset is not None:
            if self.model.preset not in PRESETS:
                raise ValueError(
                    f"unknown model.preset {self.model.preset!r}; presets: {sorted(PRESETS)}"
                )
        if self.model.kind == "lsq":
            if self.data.partition != "iid":
                raise ValueError(
                    "the homogeneous lsq problem is generated pre-sharded with "
                    f"identical client distributions; data.partition="
                    f"{self.data.partition!r} is meaningless for it (use 'iid')"
                )
            if self.data.num_points % self.fed.clients:
                raise ValueError(
                    f"data.num_points ({self.data.num_points}) must divide evenly "
                    f"across fed.clients ({self.fed.clients}) for the lsq task"
                )
        if self.data.kind == "token_stream" and self.data.partition != "iid":
            raise ValueError(
                "the token-stream pipeline partitions windows iid; "
                f"data.partition={self.data.partition!r} needs labels "
                "(use the classification data kind)"
            )

    def _validate_method(self):
        from repro_torch.fed.engine import ROUND_METHODS

        if self.fed.method not in ROUND_METHODS:
            raise ValueError(
                f"unknown fed.method {self.fed.method!r}; registered: {sorted(ROUND_METHODS)}"
            )

    def _validate_cross(self):
        k = self.participation.cohort_size
        if k is not None and k > self.fed.clients:
            raise ValueError(
                f"participation.cohort_size ({k}) exceeds fed.clients ({self.fed.clients})"
            )
