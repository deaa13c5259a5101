"""Percent of the card's dense tensor-core peak for the compute dtype
(``bench/peaks.json``) that the training job's model FLOPs reach:
``tokens_per_s`` times the model FLOPs a token (``bench/train_flops.py``,
forward and backward, no recomputation) over the peak.  None where the
card or the dtype has no listed peak."""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "peaks.json").read_text())


def read(ctx):
    peak = PEAKS.get(ctx.get("device_kind"), {}).get(f"{ctx['compute_dtype']}_dense_flops_per_s")
    if peak is None:
        return None
    window = ctx["window"]
    return 100.0 * window["tokens"] * ctx["flops_per_token"] / window["elapsed_s"] / peak
