"""The engine's per-decision span-site stack, which ``decision_trace``'s
disabled-tracer bar times.  It imports nothing, so ``tools/bar_noise.py``
can time the same stack in a process that has not imported torch."""

from __future__ import annotations


def decision_sites(nt, call, shards: int = 1, kernel: str = "eirate_topk"):
    """``call()`` under the sites the engine opens for one decision:
    event -> decide -> posterior/score -> pad_upload/shard_decide.  Each
    layer tests ``nt.enabled`` once and, disabled, opens no span: the
    engine (``StreamEngine._drain`` / ``_try_launch``: its event and decide
    sites), the control plane (``ControlPlane.choose_mdmt``: posterior and
    score) and the scorer (``ShardedScorer.decide_topk``: pad_upload and
    shard_decide)."""
    if not nt.enabled:
        return _control_plane_sites(nt, call, shards, kernel)
    nt.begin_trace(0)
    with nt.span("event", kind="finish"):
        with nt.span("decide", device=0):
            return _control_plane_sites(nt, call, shards, kernel)


def _control_plane_sites(nt, call, shards, kernel):
    if not nt.enabled:
        return _scorer_sites(nt, call, shards, kernel)
    with nt.span("posterior", scorer="sharded"):
        pass
    with nt.span("score", scorer="sharded"):
        return _scorer_sites(nt, call, shards, kernel)


def _scorer_sites(nt, call, shards, kernel):
    if not nt.enabled:
        return call()
    with nt.span("pad_upload"):
        pass
    with nt.span("shard_decide", shards=shards, kernel=kernel):
        return nt.sync(call())
