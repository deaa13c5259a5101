"""Episodes a second: every episode of the window's whole calls over the
host clock from the first call's start to the last call's end (each call's
host set-up, step loop and trial-log assembly included)."""


def read(ctx):
    return ctx["window"]["episodes"] / ctx["window"]["elapsed_s"]
