from repro_torch.models.config import (  # noqa: F401
    LowRankPolicy,
    ModelConfig,
    reduced,
)
from repro_torch.models.model import Model, build_model  # noqa: F401
