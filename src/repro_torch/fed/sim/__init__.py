"""The system simulator of the port (the JAX package's ``repro.fed.sim``):
a virtual clock, per-client system profiles, and the sync, async (FedBuff)
and hierarchical engines that price federated rounds in seconds."""
from repro_torch.fed.sim.clock import Timeline, VirtualClock  # noqa: F401
from repro_torch.fed.sim.engines import (  # noqa: F401
    AsyncFederatedEngine,
    HierarchicalEngine,
    SyncSimEngine,
    make_sim_engine,
)
from repro_torch.fed.sim.events import (  # noqa: F401
    ClientAvailable,
    ClientDropped,
    ClientFinished,
    EventQueue,
    ServerAggregate,
)
from repro_torch.fed.sim.profiles import (  # noqa: F401
    Fleet,
    SystemProfile,
    client_round_flops,
)
