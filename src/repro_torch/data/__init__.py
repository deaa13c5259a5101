"""The trial executor's synthetic data pipeline (numpy)."""

from .pipeline import DataConfig, SyntheticLMStream, make_batch_iterator  # noqa: F401
