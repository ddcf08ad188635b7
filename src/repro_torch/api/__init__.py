"""The port's experiment API: specs (TOML / JSON files, content hash),
``build(spec, device=...)`` for training and ``serve(spec, device=...)`` for
serving; ``python -m repro_torch.api {validate,describe,run,serve}`` on the
shell."""
from repro_torch.api.experiment import (  # noqa: F401
    Experiment,
    ServeSession,
    build,
    resolve_device,
    serve,
)
from repro_torch.api.serialization import (  # noqa: F401
    content_hash,
    toml_dumps,
    toml_loads,
)
from repro_torch.api.spec import (  # noqa: F401
    CheckpointSpec,
    DataSpec,
    EngineSpec,
    ExperimentSpec,
    FedSpec,
    ModelSpec,
    ParticipationSpec,
    ServeSpec,
    SimSpec,
    TelemetrySpec,
    WireSpec,
    load_spec,
)
from repro_torch.api.tasks import PRESETS, lm_model_config, register_task  # noqa: F401
