"""Snapshot store of the port (numpy and JSON; the reference's layout)."""

from .store import (  # noqa: F401
    SCHEMA_VERSION,
    CheckpointError,
    CheckpointManager,
    latest_step,
    load_arrays,
    load_checkpoint,
    save_checkpoint,
)
