"""FeDLRT in PyTorch: factor algebra, the dynamical low-rank primitives,
the round programs (FeDLRT and its baselines) and the comm cost model."""
from repro_torch.core.factorization import (  # noqa: F401
    AugmentedFactor,
    LowRankFactor,
    augmented_mask,
    init_factor,
    is_factor,
    lr_matmul,
    lr_rowlookup,
    mask_coeff,
    materialize,
    orthonormal_init,
    rank_mask,
)
from repro_torch.core.round import (  # noqa: F401
    SERVER,
    FedConfig,
    RoundContext,
    RoundProgram,
    local_sgd_scan,
    make_aggregator,
    run_round,
    split_server,
    variance_correction,
)
from repro_torch.core.fedlrt import FedLRTProgram, fedlrt_round, make_fedlrt_step  # noqa: F401
from repro_torch.core.baselines import (  # noqa: F401
    FedAvgProgram,
    FedLinProgram,
    FedLRTNaiveProgram,
    fedavg_round,
    fedlin_round,
    fedlrt_naive_round,
)
