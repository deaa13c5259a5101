"""Registry of the architectures: ``get_config(<arch id>)``.

Each module exposes ``config()`` (the published widths) and
``smoke_config()`` (a reduced same-family config for the CPU tests),
copied from the reference's ``repro.configs``: its ten architectures, in
its order.
"""

from __future__ import annotations

import importlib

ARCH_IDS = (
    "musicgen-medium",
    "zamba2-2.7b",
    "paligemma-3b",
    "mamba2-1.3b",
    "arctic-480b",
    "qwen3-moe-235b-a22b",
    "qwen3-4b",
    "qwen3-8b",
    "olmo-1b",
    "h2o-danube-3-4b",
)

_MODULES = {
    "musicgen-medium": "musicgen_medium",
    "zamba2-2.7b": "zamba2_2p7b",
    "paligemma-3b": "paligemma_3b",
    "mamba2-1.3b": "mamba2_1p3b",
    "arctic-480b": "arctic_480b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "qwen3-4b": "qwen3_4b",
    "qwen3-8b": "qwen3_8b",
    "olmo-1b": "olmo_1b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
}

# (seq_len, global_batch, kind); kind: train | prefill | decode | long_decode
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "long_decode"),
}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"{__name__}.{_MODULES[arch_id]}")


def get_config(arch_id: str):
    return _module(arch_id).config()


def get_smoke_config(arch_id: str):
    return _module(arch_id).smoke_config()


def shape_applicable(cfg, shape_name: str) -> bool:
    """long_500k only for sub-quadratic-context archs."""
    if shape_name == "long_500k":
        return cfg.supports_long_context
    return True
