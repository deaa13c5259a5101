"""Seconds from the process's start to the window: imports and the
system's set-up (a sweep's problem, ground-truth draws and warm call; a
training job's weights, state and checked steps)."""


def read(ctx):
    return ctx["setup_s"]
