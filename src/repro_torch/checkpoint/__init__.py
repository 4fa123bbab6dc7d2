from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    load_checkpoint, save_checkpoint,
)
