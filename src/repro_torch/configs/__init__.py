from repro_torch.configs.arch import (
    ArchConfig,
    MoeCfg,
    RglruCfg,
    SsmCfg,
    get_config,
    get_smoke_config,
    list_archs,
    register,
)

__all__ = [
    "ArchConfig",
    "MoeCfg",
    "RglruCfg",
    "SsmCfg",
    "get_config",
    "get_smoke_config",
    "list_archs",
    "register",
]
