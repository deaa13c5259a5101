"""The trial executor's synthetic data pipeline (numpy)."""

from .pipeline import (  # noqa: F401
    DataConfig,
    SyntheticLMStream,
    make_batch_iterator,
    random_batch,
    seq_key,
    split_last,
)
