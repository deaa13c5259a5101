"""The batched sweep's spans (``simulate_batch(..., tracer=)``), on the CPU.

A traced call returns what an untraced one returns, for each policy and a
mixed batch; its span tree is the one ``simulate_batch``'s docstring
documents, with the byte counts the uploaded and copied-back arrays hold;
the copies and the loop lie inside ``wall_seconds``; a disabled tracer
records nothing.  Every span record carries the thread's CPU time beside
its wall time, and ``Tracer(profiler=True)`` puts every span in a
``torch.profiler`` trace as a range of its name.
"""

import dataclasses
import time
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.sim_batched import EpisodeSpec, simulate_batch  # noqa: E402
from repro_torch.core.tenancy import synthetic_matern_problem  # noqa: E402
from repro_torch.obs import NULL_TRACER, Tracer, aggregate_spans  # noqa: E402

#: the root span's children, in order
PHASES = ("validate", "block_shape", "pack", "sub_keys", "upload", "loop", "drain",
          "copy_back", "trial_logs", "assemble")
N, M_PER = 3, 8
BATCHES = {
    "mdmt": [EpisodeSpec("mdmt", M, seed=i) for i, M in enumerate((1, 2, 3))],
    "round_robin": [EpisodeSpec("round_robin", M, seed=i) for i, M in enumerate((1, 4))],
    "random": [EpisodeSpec("random", M, seed=11 + i) for i, M in enumerate((1, 2, 3))],
    "mixed": [EpisodeSpec("random", 2, seed=5), EpisodeSpec("mdmt", 3, seed=1),
              EpisodeSpec("round_robin", 2, seed=2, device_speeds=(1.0, 2.0)),
              EpisodeSpec("mdmt", 1, seed=3)],
}


@pytest.fixture(scope="module")
def problem():
    return synthetic_matern_problem(num_users=N, num_models_per_user=M_PER, seed=5)


def _traced(problem, specs, trace_id=7, **kw):
    tracer = Tracer(enabled=True, **kw)
    tracer.begin_trace(trace_id)
    return simulate_batch(problem, specs, device="cpu", tracer=tracer), tracer


def _tick_us() -> float:
    """One step of the thread CPU clock here, in us."""
    t = time.thread_time_ns()
    while (u := time.thread_time_ns()) == t:
        pass
    return (u - t) / 1e3


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_traced_call_returns_the_untraced_result(problem, batch):
    specs = BATCHES[batch]
    want = simulate_batch(problem, specs, device="cpu")
    got, tracer = _traced(problem, specs)
    assert len(tracer.records()) == len(PHASES) + 1
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if f.name == "wall_seconds":
            continue
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), f.name
        else:
            assert a is b or a == b, f.name


def test_span_tree_counts_and_wall_seconds(problem):
    specs = BATCHES["mixed"]
    res, tracer = _traced(problem, specs)
    B, n, Mmax = len(specs), N * M_PER, 3
    T, Np, warm = n + Mmax, 4, N * 2
    # K's blocks, mu0, its diagonal, costs (float32); the warm-start queue,
    # policy ids (int64); speeds, truths, z_star, (float32); the key words
    # (int64); slot ends (float32), slot sequence numbers (int64), the
    # worst truths (float32); jitter and floor (float32)
    h2d = (4 * (N * M_PER * M_PER + 3 * n) + 8 * (warm + B)
           + 4 * (B * Mmax + B * n + B * Np) + 8 * 2 * B * T
           + 4 * B * Mmax + 8 * B * Mmax + 4 * B * Np + 2 * 4)
    # ten (B, T) step logs: observed model, time, instantaneous and
    # cumulative regret, launched, model, hint, device, start, end; then
    # decisions (int64) and end time (float32) a row
    d2h = B * T * (8 + 4 + 4 + 4 + 1 + 8 + 8 + 8 + 4 + 4) + B * (8 + 4)
    # on the CPU every step runs eagerly: no step is replayed from a CUDA
    # graph, and the loop has no ``capture`` child
    attrs = {"upload": (("bytes_h2d", h2d),),
             "loop": (("eager_steps", T), ("graph_steps", 0), ("steps", T)),
             "copy_back": (("bytes_d2h", d2h),)}
    root = ("episodes", B), ("models", n), ("policies", ("mdmt", "random", "round_robin")), \
        ("steps", T)
    assert tracer.signature() == [(7, i + 1, 0, name, attrs.get(name, ()))
                                  for i, name in enumerate(PHASES)] + \
        [(7, 0, None, "simulate_batch", root)]
    dur = {r["name"]: r["dur_us"] for r in tracer.records()}
    inside = sum(dur[k] for k in ("upload", "loop", "drain", "copy_back"))
    assert inside <= res.wall_seconds * 1e6 <= dur["simulate_batch"]
    assert sum(dur[k] for k in PHASES) <= dur["simulate_batch"]


def test_disabled_tracer_records_nothing(problem):
    tracer = Tracer(enabled=False)
    simulate_batch(problem, BATCHES["mixed"], device="cpu", tracer=tracer)
    simulate_batch(problem, BATCHES["mixed"], device="cpu")
    assert tracer.records() == [] and NULL_TRACER.records() == []


def test_cpu_time_beside_wall_time(problem):
    _, tracer = _traced(problem, BATCHES["random"])
    tick = _tick_us()
    with tracer.span("asleep"):
        time.sleep(0.2)
    records = tracer.records()
    for r in records:
        assert 0.0 <= r["cpu_us"] <= r["dur_us"] * 1.01 + 2 * tick + 20.0, r["name"]
    assert records[-1]["cpu_us"] < 0.25 * records[-1]["dur_us"]
    agg = aggregate_spans(records)
    for r in records[:-1]:
        path = r["name"] if r["parent"] is None else f"simulate_batch/{r['name']}"
        assert agg[path]["cpu_us"] == r["cpu_us"]


def test_profiler_bridge_puts_every_span_in_the_trace(problem):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, tracer = _traced(problem, BATCHES["mixed"], profiler=True)
    ranges = {}
    names = Counter()
    for e in prof.profiler.kineto_results.events():
        names[e.name()] += 1
        ranges[e.name()] = (e.start_ns(), e.start_ns() + e.duration_ns())
    for name in ("simulate_batch", *PHASES):
        assert names[name] == 1, name
    lo, hi = ranges["simulate_batch"]
    assert all(lo <= ranges[name][0] <= ranges[name][1] <= hi for name in PHASES)
