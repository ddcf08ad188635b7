"""Hand-written Hopper kernels for the low-rank chain, for flash attention and
for Mamba's state recurrence (the selective scan), their plain PyTorch
versions, and the model-level dispatch (see
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
from repro_torch.kernels.selective_scan import selective_scan  # noqa: F401
