"""Milliseconds a step of the step loop: the window's calls' summed
``wall_seconds`` over their summed steps (T a call)."""


def read(ctx):
    calls = ctx["window"]["calls"]
    return 1e3 * sum(c["wall_s"] for c in calls) / (ctx["steps"] * len(calls))
