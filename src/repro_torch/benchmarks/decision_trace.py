"""Span-level cost attribution of one sharded GP-EI decision.

The port of the JAX package's ``benchmarks/decision_trace.py``.  Two
measurements per (|L|, shard count) point:

* ``decision_trace_L{n}_S{s}`` — the readout -> score -> pick pipeline run
  phase by phase (``ShardedScorer.readout_decide_topk_phased``): the same
  launches cut at their two natural barriers, each phase closed under an
  ``obs`` tracer span that waits for the card.  The row carries the
  per-phase means (``readout`` — kernel 1 on each shard's column slice of
  the (k_obs, n) W buffer; ``score_topk`` — kernel 3 and the local top-k
  of each shard; ``gather_pick`` — the candidates' copy to the first
  shard's device and the global pick), the share of the root ``decide``
  span they attribute (**>= 90% at |L| = 100k**, asserted), and the
  unphased call for reference (the phase split adds waits, so phases sum
  above it: attribution is about *where*, the unphased call about *how
  fast*).

* ``decision_overhead_L{n}_S{s}`` — the cost of the instrumentation when
  tracing is OFF.  The engine's per-decision span-site stack
  (``sites.decision_sites``: event -> decide -> posterior/score ->
  pad_upload/shard_decide, on a disabled tracer: each site one branch +
  one shared no-op context manager) is
  timed directly over thousands of iterations (``site_us``), and the
  row's ``overhead_pct`` is that stack as a share of the bare decision
  (**< 1% at |L| = 100k**, asserted).  The paired bare-vs-wrapped
  decision timings ride along as reference fields but do not gate.  The
  three loops run the reference's calls interleaved in rounds
  (``common.interleaved``), so the stack and the decision it is held
  against are timed under the same conditions of the host.

Shard counts (1, 8), every shard on one device (``shard_scale``'s
protocol): the S = 8 rows measure one controller walking 8 shard slices of
one H100, not an 8-card mesh.  Every timed decision is waited for, so the
spans and the unphased time measure device work, not enqueue time.
"""

from __future__ import annotations

from . import common
from .common import emit, interleaved, time_us
from .shard_scale import K_OBS, TOPK, _setup
from .sites import decision_sites


def _mesh_sizes() -> list[int]:
    return [1, 8]


def _sizes() -> list[int]:
    return [2048] if common.FAST else [10_000, 100_000]


def bench_attribution(device=None) -> None:
    from ..obs import Tracer, aggregate_spans

    fast = common.FAST
    iters = 5 if fast else 20
    for n in _sizes():
        for s in _mesh_sizes():
            sc, args = _setup(n, s, device)
            fused_us = time_us(sc.readout_decide_topk, *args,
                               iters=iters, warmup=2, sync=True)

            tr = Tracer(enabled=True)
            sc.tracer = tr
            for _ in range(2):              # warm all three phases
                sc.readout_decide_topk_phased(*args)
            tr.spans.clear()
            for i in range(iters):
                tr.begin_trace(i)
                with tr.span("decide"):
                    sc.readout_decide_topk_phased(*args)

            agg = aggregate_spans(tr.records())
            root_us = agg["decide"]["total_us"]
            phases = {p: agg[f"decide/{p}"]["total_us"] / iters
                      for p in ("readout", "score_topk", "gather_pick")}
            attributed = 100.0 * sum(phases.values()) * iters / root_us
            emit(f"decision_trace_L{n}_S{s}", root_us / iters,
                 live_models=n, shards=s, k_obs=K_OBS, topk=TOPK,
                 readout_us=f"{phases['readout']:.1f}",
                 score_topk_us=f"{phases['score_topk']:.1f}",
                 gather_pick_us=f"{phases['gather_pick']:.1f}",
                 fused_us=f"{fused_us:.1f}",
                 attributed_pct=f"{attributed:.2f}")
            # the reference's bar, unchanged
            assert fast or n < 100_000 or attributed >= 90.0, (
                f"spans attribute only {attributed:.1f}% of the "
                f"L={n} S={s} decision (need >= 90%)")


def _nothing() -> None:
    return None


def bench_disabled_overhead(device=None) -> None:
    from ..obs import Tracer

    fast = common.FAST
    iters = 10 if fast else 30
    nt = Tracer(enabled=False)
    for n in _sizes():
        for s in _mesh_sizes():
            sc, args = _setup(n, s, device)

            def bare():
                return sc.readout_decide_topk(*args)

            # the gating number: the disabled stack measured alone, not as
            # the difference of two noisy decision means; its loop and the
            # bare decision's interleaved, as the bar holds one against the
            # other
            us = interleaved({
                "bare": (lambda k: time_us(bare, iters=k, warmup=2,
                                           sync=True), iters),
                "wrapped": (lambda k: time_us(decision_sites, nt, bare, s,
                                              sc.kernel, iters=k, warmup=2,
                                              sync=True), iters),
                "site": (lambda k: time_us(decision_sites, nt, _nothing, s,
                                           sc.kernel, iters=k, warmup=50),
                         300 if fast else 2000)})
            bare_us, wrapped_us, site_us = us["bare"], us["wrapped"], us["site"]
            overhead = 100.0 * site_us / bare_us
            emit(f"decision_overhead_L{n}_S{s}", site_us,
                 live_models=n, shards=s, bare_us=f"{bare_us:.1f}",
                 wrapped_us=f"{wrapped_us:.1f}",
                 paired_delta_pct=f"{100 * (wrapped_us - bare_us) / bare_us:.3f}",
                 overhead_pct=f"{overhead:.4f}")
            assert fast or n < 100_000 or overhead < 1.0, (
                f"disabled-tracer overhead {overhead:.2f}% at L={n} S={s} "
                "(need < 1%)")


def main(device=None) -> None:
    bench_attribution(device)
    bench_disabled_overhead(device)


if __name__ == "__main__":
    common.run_standalone("torch_decision_trace", main, __doc__)
