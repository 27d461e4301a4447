from repro_torch.models.params import (  # noqa: F401
    Transformer, abstract_params, abstract_state, count_params,
    from_jax_params, init_params, init_state,
)
from repro_torch.models.transformer import (  # noqa: F401
    decode_step, forward_train, greedy_generate, prefill,
)
