"""The trial executor's training: the train step (autograd through the
models' plain route), AdamW with clipping and a warmup-cosine schedule,
and int8 error-feedback gradient compression."""

from .compress import (  # noqa: F401
    compress_tree,
    decompress_tree,
    dequantize,
    init_error_state,
    quantize,
    quantize_ef,
    wire_bytes_saved,
)
from .optimizer import (  # noqa: F401
    OptConfig,
    adamw_init,
    adamw_state_specs,
    adamw_update,
    global_norm,
    lr_at,
)
from .train_step import TrainState, make_train_step, train_state_specs  # noqa: F401
