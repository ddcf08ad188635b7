"""Factor-resident serving: engine + continuous-batching scheduler."""
from repro_torch.serve.engine import ServeEngine  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    SCHED_MODES,
    Completion,
    ContinuousScheduler,
    Request,
)
