"""Registry of the ported architectures: ``get_config(<arch id>)``.

Each module exposes ``config()`` (the published widths) and
``smoke_config()`` (a reduced same-family config for the CPU tests),
copied from the reference's ``repro.configs``.  Only the dense and ssm
families are ported; the reference's other architectures raise and name
the slice they wait for.
"""

from __future__ import annotations

import importlib

ARCH_IDS = (
    "mamba2-1.3b",
    "qwen3-4b",
    "qwen3-8b",
    "olmo-1b",
    "h2o-danube-3-4b",
)

_MODULES = {
    "mamba2-1.3b": "mamba2_1p3b",
    "qwen3-4b": "qwen3_4b",
    "qwen3-8b": "qwen3_8b",
    "olmo-1b": "olmo_1b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
}

# the reference's architectures that are not ported yet, by family
_NOT_PORTED = {
    "musicgen-medium": "audio",
    "zamba2-2.7b": "hybrid",
    "paligemma-3b": "vlm",
    "arctic-480b": "moe",
    "qwen3-moe-235b-a22b": "moe",
}

# (seq_len, global_batch, kind); kind: train | prefill | decode | long_decode
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "long_decode"),
}


def _module(arch_id: str):
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id} ({_NOT_PORTED[arch_id]} family) is not ported yet: it "
            "waits for the data plane's next slice")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; ported: {sorted(_MODULES)}")
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
