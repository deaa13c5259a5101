"""The benchmark of the port: its batched GP-EI sweep engine and its
training step (``bench/run.py``)."""

import importlib.util
from pathlib import Path


def load_module(path: Path, name: str):
    """The module in ``path``: the pieces a cell names (system, generator,
    metric reader) are found as files, by name."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
