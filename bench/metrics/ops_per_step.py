"""Aten operations a call dispatches on the device, over its T steps (one
call counted by a dispatch mode after the window).  A count: it repeats
exactly."""


def read(ctx):
    return None if ctx["ops"] is None else ctx["ops"] / ctx["steps"]
