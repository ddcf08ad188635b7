from repro_torch.checkpoint.io import load_checkpoint, params_from_numpy  # noqa: F401
