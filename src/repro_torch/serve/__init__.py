"""Low-rank serving: factor-resident decode + continuous batching.

Construction goes through ``repro_torch.api.experiment.serve(spec)``.
"""
from repro_torch.serve.engine import ServeEngine, decode_matmul_flops  # noqa: F401
from repro_torch.serve.quantize import (  # noqa: F401
    QUANT_MODES,
    QuantizedFactor,
    dequantize_params,
    materialize_params,
    quantization_error_bound,
    quantize_params,
    rank_slice_params,
    resident_bytes,
)
from repro_torch.serve.scheduler import (  # noqa: F401
    SCHED_MODES,
    Completion,
    ContinuousScheduler,
    Request,
)
