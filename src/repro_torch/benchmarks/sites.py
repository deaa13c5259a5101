"""The engine's per-decision span-site stack, which ``decision_trace``'s
disabled-tracer bar times.  It imports nothing, so ``tools/bar_noise.py``
can time the same stack in a process that has not imported torch."""

from __future__ import annotations


def decision_sites(nt, call, shards: int = 1, kernel: str = "eirate_topk"):
    """``call()`` under the sites the engine opens for one decision:
    event -> decide -> posterior/score -> pad_upload/shard_decide.  On a
    disabled tracer every site is one branch and one shared no-op
    ``__enter__``/``__exit__``."""
    nt.begin_trace(0)
    with nt.span("event", kind="finish"):
        with nt.span("decide", device=0):
            with nt.span("posterior", scorer="sharded"):
                pass
            with nt.span("score", scorer="sharded"):
                with nt.span("pad_upload"):
                    pass
                with nt.span("shard_decide", shards=shards, kernel=kernel):
                    return nt.sync(call())
