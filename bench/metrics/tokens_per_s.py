"""Tokens a second a training job completes: the tokens of every window
step over the host clock from the first window step's start to the last
one's end (each step's feed, forward, backward and optimizer update, and
the read-back of its loss, included)."""


def read(ctx):
    return ctx["window"]["tokens"] / ctx["window"]["elapsed_s"]
