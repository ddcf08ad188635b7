"""Federated runtime of the port: participation policies and the engine."""
from repro_torch.fed.participation import MODES, Participation  # noqa: F401
