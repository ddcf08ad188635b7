"""Hand-written Hopper kernels for the low-rank chain and for flash attention,
their plain PyTorch versions, and the model-level dispatch (see
:mod:`repro_torch.kernels.ops`).
"""
from repro_torch.kernels.coeff_grad import atb  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.lowrank_matmul import avt, xus  # noqa: F401
from repro_torch.kernels.ops import (  # noqa: F401
    KERNEL_POLICIES,
    coeff_grad_kernels,
    lowrank_apply,
    lowrank_apply_nd,
    use_kernels_for,
)
