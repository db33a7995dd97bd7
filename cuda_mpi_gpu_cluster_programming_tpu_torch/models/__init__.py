from .alexnet import (  # noqa: F401
    ConvSpec,
    PoolSpec,
    LrnSpec,
    Blocks12Config,
    BLOCKS12,
    forward_blocks12,
    output_shape,
)
from .alexnet_full import (  # noqa: F401
    AlexNetConfig,
    ALEXNET,
    forward_alexnet,
    fc_head,
    predict,
    init_full_deterministic,
    init_full_random,
    spatial_output_shape,
)
from .init import (  # noqa: F401
    init_params_deterministic,
    init_params_random,
    deterministic_input,
    random_input,
    to_reference_layout,
    from_reference_layout,
    params_from_jax,
)
from .transformer import (  # noqa: F401
    TransformerConfig,
    TINY_LM,
    TransformerLM,
    init_transformer,
    lm_params_from_jax,
    forward_lm,
    lm_loss,
    init_kv_cache,
    decode_logits,
    generate,
)
