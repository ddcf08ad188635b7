from repro_torch.core.factorization import (  # noqa: F401
    LowRankFactor,
    init_factor,
    is_factor,
    lr_matmul,
    materialize,
    orthonormal_init,
    rank_mask,
)
