from repro_torch.checkpoint.io import (  # noqa: F401
    load_checkpoint,
    load_checkpoint_meta,
    params_from_numpy,
    save_checkpoint,
)
