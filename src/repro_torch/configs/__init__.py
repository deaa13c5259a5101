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


# Optimized sharding-rule selection (the reference's, verbatim):
#   qrows  — archs whose head counts don't divide the 16-way model axis
#            (attention otherwise replicates across TP)
#   puredp — small dense models where TP activation all-reduces dominate
#            (ZeRO-3 pure DP)
#   fsdp   — very large MoE trains (per-device argument bytes)
#   default otherwise.
_PREFERRED: dict[tuple[str, str], str] = {}
for _shape in ("train_4k", "prefill_32k", "decode_32k"):
    _PREFERRED[("musicgen-medium", _shape)] = "qrows"
for _shape in ("train_4k", "prefill_32k"):
    _PREFERRED[("olmo-1b", _shape)] = "puredp"
    _PREFERRED[("mamba2-1.3b", _shape)] = "puredp"
_PREFERRED[("qwen3-8b", "train_4k")] = "puredp"
_PREFERRED[("arctic-480b", "train_4k")] = "fsdp"
_PREFERRED[("qwen3-moe-235b-a22b", "train_4k")] = "fsdp"


def preferred_rules_name(arch_id: str, shape_name: str) -> str:
    """The tuned rules variant for a cell ("default" if untuned)."""
    return _PREFERRED.get((arch_id, shape_name), "default")


def cells(arch_ids=ARCH_IDS):
    """All (arch, shape) dry-run cells, with applicability filtering."""
    out = []
    for a in arch_ids:
        cfg = get_config(a)
        for s in SHAPES:
            if shape_applicable(cfg, s):
                out.append((a, s))
    return out
