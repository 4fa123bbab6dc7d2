from repro_torch.optim.optimizers import (  # noqa: F401
    OPTIMIZERS, SGD, Adam, get_optimizer,
)
