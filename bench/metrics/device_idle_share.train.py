"""Percent of one profiled training step's wall time in which no kernel,
copy or set ran on the device."""


def read(ctx):
    prof = ctx["profile"]
    return None if prof is None else 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
