from repro_torch.configs.base import (  # noqa: F401
    ATTN, SWA, MLA, RGLRU, MAMBA2,
    ArchConfig, MoEConfig, InputShape, INPUT_SHAPES, ASSIGNED_ARCHS,
    get_config, list_configs, register,
)
