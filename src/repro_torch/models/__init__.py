from repro_torch.models.model import (  # noqa: F401
    forward, init_params, loss_fn, param_shapes,
)
