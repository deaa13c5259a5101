"""Percent of the memory roofline the step loop's kernels reach: the least
bytes the profiled call's steps must move (``bench/sweep_bytes.py``) at
the card's HBM bandwidth (``bench/peaks.json``), over the call's summed
kernel time in the device trace."""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "peaks.json").read_text())


def read(ctx):
    prof, peak = ctx["profile"], PEAKS.get(ctx.get("device_kind"))
    if prof is None or peak is None or ctx["bytes"] is None:
        return None
    return 100.0 * ctx["bytes"] / peak["hbm_bytes_per_s"] / prof["kernel_s"]
