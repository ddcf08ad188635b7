from repro_torch.optim.optimizers import Optimizer, adam, make_optimizer, sgd  # noqa: F401
from repro_torch.optim.schedules import constant_schedule, cosine_schedule  # noqa: F401
