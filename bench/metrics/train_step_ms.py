"""Milliseconds a training step: the window's host-clock seconds over its
steps."""


def read(ctx):
    return 1e3 * ctx["window"]["elapsed_s"] / ctx["window"]["steps"]
