"""Federated runtime of the port: participation policies, the engine and
(in :mod:`repro_torch.fed.sim`) the system simulator's engines."""
from repro_torch.fed.participation import MODES, Participation  # noqa: F401
