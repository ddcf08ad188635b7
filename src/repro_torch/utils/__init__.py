from repro_torch.utils.tree import (  # noqa: F401
    tree_add,
    tree_axpy,
    tree_global_norm,
    tree_mean_leading_axis,
    tree_scale,
    tree_sub,
    tree_zeros_like,
)
