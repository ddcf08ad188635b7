"""The port's serving API: specs and ``serve(spec, device=...)``."""
from repro_torch.api.experiment import ServeSession, resolve_device, serve  # noqa: F401
from repro_torch.api.spec import ExperimentSpec, ModelSpec, ServeSpec  # noqa: F401
from repro_torch.api.tasks import PRESETS, lm_model_config  # noqa: F401
