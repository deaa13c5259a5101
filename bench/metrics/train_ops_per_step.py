"""Aten operations one training step dispatches on the device, forward,
backward (recomputation included) and optimizer, counted by a dispatch mode
over the first step of a traced run; None unless the backward's operations
were seen.  A count: it repeats exactly."""


def read(ctx):
    return ctx["step_ops"]
