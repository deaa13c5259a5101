"""Seconds from the process's start to the first timed call: imports, the
problem, the ground-truth draws and the warm call."""


def read(ctx):
    return ctx["setup_s"]
