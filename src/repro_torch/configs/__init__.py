from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS, LayerSpec, MambaConfig, ModelConfig, MoEConfig, canonical_id,
    get_config,
)
