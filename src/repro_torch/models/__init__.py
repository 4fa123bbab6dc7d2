from repro_torch.models.model import (  # noqa: F401
    decode_step, forward, init_cache, init_params, loss_fn, param_shapes,
)
