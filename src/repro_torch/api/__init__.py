"""The port's experiment API: specs, ``build(spec, device=...)`` for
training and ``serve(spec, device=...)`` for serving."""
from repro_torch.api.experiment import (  # noqa: F401
    Experiment,
    ServeSession,
    build,
    resolve_device,
    serve,
)
from repro_torch.api.spec import (  # noqa: F401
    DataSpec,
    EngineSpec,
    ExperimentSpec,
    FedSpec,
    ModelSpec,
    ParticipationSpec,
    ServeSpec,
)
from repro_torch.api.tasks import PRESETS, lm_model_config, register_task  # noqa: F401
