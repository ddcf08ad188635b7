from repro_torch.data.synthetic import (  # noqa: F401
    LeastSquaresProblem,
    make_classification_data,
    make_heterogeneous_lsq,
    make_homogeneous_lsq,
    make_token_stream,
)
from repro_torch.data.partition import (  # noqa: F401
    partition_dirichlet,
    partition_iid,
    partition_sizes,
)
from repro_torch.data.pipeline import FederatedBatcher  # noqa: F401
