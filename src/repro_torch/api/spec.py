"""The experiment spec: what trains or is served, on what data, and how.

The port's ``repro.api.spec``: :class:`ModelSpec` (the ``lm``, ``mlp`` and
``lsq`` tasks), :class:`DataSpec`, :class:`FedSpec`,
:class:`ParticipationSpec`, :class:`EngineSpec`, :class:`WireSpec`,
:class:`SimSpec`, :class:`CheckpointSpec`, :class:`TelemetrySpec`,
:class:`ServeSpec` and the :class:`ExperimentSpec` that holds them. Field
names, defaults and validation follow the JAX package, and so do the
dict / TOML / JSON forms and :meth:`ExperimentSpec.spec_hash`: one spec file
parses and hashes the same under both packages, which lets a checkpoint
written by one resume in the other.

Every value the JAX package accepts runs in the port: the async and hier
engines and a ``sim.profile`` go to :mod:`repro_torch.fed.sim`.
"""
import dataclasses
from dataclasses import field
from typing import Optional

from repro_torch.api.serialization import (
    content_hash,
    from_plain_dict,
    parse_override,
    set_dotted,
    to_plain_dict,
    toml_dumps,
    toml_loads,
)
from repro_torch.kernels.ops import check_kernel_policy
from repro_torch.serve.quantize import QUANT_MODES
from repro_torch.serve.scheduler import SCHED_MODES
from repro_torch.telemetry.sinks import SINK_NAMES

CORRECTIONS = ("auto", "none", "simplified", "full")
#: engine kinds of the JAX package; the port runs "sync"
ENGINE_KINDS = ("sync", "async", "hier")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """What trains or is served: a task family plus its model knobs.

    ``kind`` selects a registered task (:mod:`repro_torch.api.tasks`):
    ``"lm"``, a decoder LM from a named ``preset`` *or* an architecture
    registry ``arch`` (exactly one); ``"mlp"``, the fig-5-style CV proxy
    head with a FeDLRT-factorized hidden layer; ``"lsq"``, the paper's
    §5.1 least-squares problem.
    """

    kind: str = "lm"
    # lm task: exactly one of preset / arch
    preset: Optional[str] = None
    arch: Optional[str] = None
    smoke: bool = False
    kernels: str = "auto"
    # mlp / lsq tasks
    dim: int = 64
    classes: int = 10
    hidden: int = 256
    r_max: int = 24
    lowrank: bool = True

    def __post_init__(self):
        check_kernel_policy(self.kernels)
        for f_ in ("dim", "classes", "hidden", "r_max"):
            if getattr(self, f_) <= 0:
                raise ValueError(f"model.{f_} must be positive")
        if self.kind == "lm" and (self.preset is None) == (self.arch is None):
            raise ValueError("model: the lm task needs exactly one of preset / arch")


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
    """When the server aggregates.

    ``None`` means "engine default" and **unset**: setting an async-only
    knob (``buffer_size``, ``staleness_power``) or a hier-only knob
    (``edges``, ``edge_rounds``) with a different ``kind`` is rejected at
    spec time. The port runs the synchronous engine; ``build()`` refuses
    the others.
    """

    kind: str = "sync"
    buffer_size: Optional[int] = None  # async: aggregate every K arrivals
    staleness_power: Optional[float] = None  # async: (1+s)^-p discount
    edges: Optional[int] = None  # hier: edge servers
    edge_rounds: Optional[int] = None  # hier: local rounds per cloud round

    def __post_init__(self):
        if self.kind not in ENGINE_KINDS:
            raise ValueError(f"engine.kind must be one of {ENGINE_KINDS}, got {self.kind!r}")
        if self.buffer_size is not None and self.buffer_size < 1:
            raise ValueError("engine.buffer_size must be >= 1")
        if self.staleness_power is not None and self.staleness_power < 0:
            raise ValueError("engine.staleness_power must be >= 0")
        if self.edges is not None and self.edges < 1:
            raise ValueError("engine.edges must be >= 1")
        if self.edge_rounds is not None and self.edge_rounds < 1:
            raise ValueError("engine.edge_rounds must be >= 1")
        for kind, knobs in (("async", ("buffer_size", "staleness_power")),
                            ("hier", ("edges", "edge_rounds"))):
            if self.kind == kind:
                continue
            for f_ in knobs:
                if getattr(self, f_) is not None:
                    raise ValueError(
                        f"engine.{f_} only applies to the {kind} engine "
                        f"(engine.kind={self.kind!r})"
                    )


@dataclasses.dataclass(frozen=True)
class WireSpec:
    """What crosses the wire(s): the client-tier codec plus the hier
    engine's edge↔cloud codec (``None`` → same as ``codec``)."""

    codec: str = "identity"
    edge_codec: Optional[str] = None

    def __post_init__(self):
        from repro_torch.fed.wire import make_codec

        make_codec(self.codec)  # raises with the codec menu on bad specs
        if self.edge_codec is not None:
            make_codec(self.edge_codec)


@dataclasses.dataclass(frozen=True)
class SimSpec:
    """System-simulation fleet (the JAX package's ``Fleet.from_spec``
    string). ``None`` = no virtual clock for the sync engine, the uniform
    fleet for async / hier (which always run on a clock)."""

    profile: Optional[str] = None

    def __post_init__(self):
        if self.profile is not None:
            from repro_torch.fed.sim.profiles import Fleet

            Fleet.from_spec(self.profile, 2)  # parse = validate


@dataclasses.dataclass(frozen=True)
class CheckpointSpec:
    """Checkpointing cadence: ``every`` rounds into ``dir`` (``dir=None``
    disables; the effective cadence is 0 without a directory)."""

    dir: Optional[str] = None
    every: int = 20

    def __post_init__(self):
        if self.every < 0:
            raise ValueError("checkpoint.every must be >= 0")

    @property
    def effective_every(self) -> int:
        return self.every if self.dir else 0


@dataclasses.dataclass(frozen=True)
class TelemetrySpec:
    """Structured telemetry: ``enabled``, a comma-separated subset of
    ``sinks`` (console, memory, jsonl, perfetto), the file sinks' ``dir``
    and the gauge sampling cadence ``sample_every``
    (:func:`repro_torch.telemetry.hub_from_spec` builds the hub)."""

    enabled: bool = False
    sinks: str = "console"
    dir: Optional[str] = None
    sample_every: int = 1

    def __post_init__(self):
        if self.sample_every < 1:
            raise ValueError("telemetry.sample_every must be >= 1")
        names = [s.strip() for s in self.sinks.split(",") if s.strip()]
        if not names:
            raise ValueError("telemetry.sinks must name at least one sink")
        for n in names:
            if n not in SINK_NAMES:
                raise ValueError(
                    f"unknown telemetry sink {n!r}; expected a comma list over {SINK_NAMES}"
                )
        if self.enabled and self.dir is None and ("jsonl" in names or "perfetto" in names):
            raise ValueError("telemetry.dir is required for the jsonl/perfetto file sinks")


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """How the factorized model is served (:mod:`repro_torch.serve`).

    ``checkpoint`` names a ``round_*.npz`` file or a checkpoint directory
    (latest round wins); ``None`` serves fresh seed-initialized params.
    ``mode`` selects continuous batching or the static-wave baseline.
    Prompts are right-padded to ``prompt_bucket`` multiples (a model with a
    Mamba or RWKV block runs each at its true length), and decode runs at
    ``(max_batch, max_prompt + max_new_tokens)``. The at-rest transforms
    (:mod:`repro_torch.serve.quantize`): ``quantize`` (none | int8 | bf16),
    ``rank_slice`` (drop inactive factor columns) and ``materialize`` (the
    dense ``U S Vᵀ`` baseline).
    """

    checkpoint: Optional[str] = None
    quantize: str = "none"
    rank_slice: bool = False
    materialize: bool = False
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
            raise ValueError(f"serve.quantize must be one of {QUANT_MODES}, got {self.quantize!r}")
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
        if self.materialize and self.quantize != "none":
            raise ValueError(
                f"serve.materialize=True densifies U S Vᵀ; serve.quantize="
                f"{self.quantize!r} compresses the factors it would destroy — pick one"
            )
        if self.materialize and self.rank_slice:
            raise ValueError(
                "serve.rank_slice drops inactive factor columns; it has nothing "
                "to act on once serve.materialize densifies — unset one"
            )

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
    wire: WireSpec = field(default_factory=WireSpec)
    sim: SimSpec = field(default_factory=SimSpec)
    checkpoint: CheckpointSpec = field(default_factory=CheckpointSpec)
    telemetry: TelemetrySpec = field(default_factory=TelemetrySpec)
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
        if self.engine.kind in ("async", "hier") and self.participation.mode != "full":
            raise ValueError(
                f"the {self.engine.kind} engine derives participation from client "
                f"availability; participation.mode={self.participation.mode!r} only "
                f"composes with the sync engine"
            )
        if self.wire.edge_codec is not None and self.engine.kind != "hier":
            raise ValueError(
                "wire.edge_codec prices the hier engine's edge↔cloud hop; it is "
                f"meaningless with engine.kind={self.engine.kind!r}"
            )
        if self.engine.kind == "hier" and self.checkpoint.dir is not None:
            raise ValueError(
                "the hier engine does not support checkpointing yet; unset checkpoint.dir"
            )
        k = self.participation.cohort_size
        if k is not None and k > self.fed.clients:
            raise ValueError(
                f"participation.cohort_size ({k}) exceeds fed.clients ({self.fed.clients})"
            )
        if self.engine.buffer_size is not None and self.engine.buffer_size > self.fed.clients:
            raise ValueError(
                f"engine.buffer_size ({self.engine.buffer_size}) exceeds fed.clients "
                f"({self.fed.clients}) — the buffer could never fill"
            )
        if self.engine.edges is not None and self.engine.edges > self.fed.clients:
            raise ValueError(
                f"engine.edges ({self.engine.edges}) exceeds fed.clients ({self.fed.clients})"
            )

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        return to_plain_dict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "ExperimentSpec":
        return from_plain_dict(cls, data)

    def to_toml(self) -> str:
        head = (
            f"# FeDLRT experiment spec (hash {self.spec_hash()}) — "
            f"run with:  python -m repro_torch.api run <this file>\n"
        )
        return head + toml_dumps(self.to_dict())

    @classmethod
    def from_toml(cls, text: str) -> "ExperimentSpec":
        return cls.from_dict(toml_loads(text))

    def to_json(self) -> str:
        import json

        return json.dumps(self.to_dict(), indent=2) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        import json

        return cls.from_dict(json.loads(text))

    def save(self, path) -> None:
        """Write the spec to ``path`` (.toml or .json, by extension)."""
        path = str(path)
        if path.endswith(".json"):
            text = self.to_json()
        elif path.endswith(".toml"):
            text = self.to_toml()
        else:
            raise ValueError(f"spec files are .toml or .json, got {path!r}")
        with open(path, "w") as fh:
            fh.write(text)

    def spec_hash(self) -> str:
        """12-hex-digit content hash, invariant under field reordering and
        TOML / JSON round trips, equal to the JAX package's for the same
        spec; stamped into checkpoints for resume safety."""
        return content_hash(self.to_dict())

    def replace(self, **changes) -> "ExperimentSpec":
        """``dataclasses.replace``: ``spec.replace(fed=..., rounds=10)``."""
        return dataclasses.replace(self, **changes)

    def with_overrides(self, items) -> "ExperimentSpec":
        """Apply dotted CLI overrides (``["fed.lr=0.1", ...]`` or a
        ``{"fed.lr": 0.1}`` mapping; values are parsed by the target field's
        type, ``"none"`` clears an optional field)."""
        if isinstance(items, dict):
            pairs = list(items.items())
        else:
            pairs = [parse_override(i) for i in items]
        data = self.to_dict()
        for path, value in pairs:
            set_dotted(type(self), data, path, value, parse_str=True)
        return type(self).from_dict(data)


def load_spec(path) -> ExperimentSpec:
    """Read an :class:`ExperimentSpec` from a .toml or .json file."""
    path = str(path)
    with open(path) as fh:
        text = fh.read()
    if path.endswith(".json"):
        return ExperimentSpec.from_json(text)
    if path.endswith(".toml"):
        return ExperimentSpec.from_toml(text)
    raise ValueError(f"spec files are .toml or .json, got {path!r}")
