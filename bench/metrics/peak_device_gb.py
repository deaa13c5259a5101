"""The allocator's peak of device memory over the window (reset at its
start), in GB: what bounds the sweep or the training job one card holds."""


def read(ctx):
    peak = ctx["window"]["peak_bytes"]
    return None if peak is None else peak / 1e9
