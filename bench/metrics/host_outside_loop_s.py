"""Host seconds a call spends outside its step loop: the harness's clock
around the call minus the call's own ``wall_seconds`` (upload, loop and
copy back), i.e. its checks, packing and trial-log assembly; the mean over
the window's calls."""


def read(ctx):
    calls = ctx["window"]["calls"]
    return sum(c["host_s"] - c["wall_s"] for c in calls) / len(calls)
