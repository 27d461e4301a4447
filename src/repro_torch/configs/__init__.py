from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS, INPUT_SHAPES, InputShape, LayerSpec, MambaConfig, ModelConfig,
    MoEConfig, all_configs, canonical_id, get_config, input_specs,
    long_context_variant,
)
