"""The data plane's models: specs, layers, attention, Mamba2 SSD, the MoE
layer and the backbone, for the reference's six families."""

from .model import (  # noqa: F401
    ModelConfig,
    decode_step,
    forward_logits_last,
    forward_loss,
    init_cache,
    init_params,
    make_cache_specs,
    model_specs,
    prefill,
)
