"""Decision-path tracing: nestable spans with deterministic ids.

The port's counterpart of ``repro.obs.trace``: the same spans, ids,
signature and JSON; ``sync`` waits for the card and the profiler bridge is
PyTorch's.

A :class:`Tracer` records *spans* — named, attributed, monotonic-clock
intervals — arranged in trees by nesting.  The design constraints come from
the control plane it instruments (DESIGN.md §13):

* **Deterministic ids.**  ``trace_id`` is set by the caller (the streaming
  engine uses the processed-event index, ``begin_trace(event_index)``) and
  ``span_id`` counts from 0 *within* each trace.  Ids therefore depend only
  on the code path taken, never on wall clock or randomness — which is what
  lets the crash-anywhere replay oracle assert that a recovered run
  re-emits the identical span tree for the replayed suffix, and what makes
  the trace id threaded into each EventLog processed record a stable
  correlation key.

* **Device-aware timing.**  CUDA launches are async: the wall time of the
  Python call that *launches* a kernel says nothing about its cost.
  ``tracer.sync(x)`` synchronizes every card that holds a tensor of ``x``
  when tracing is enabled — so the enclosing span measures execution, not
  dispatch — and is a pass-through when disabled (and for CPU tensors),
  preserving the untraced pipeline's async behavior exactly.

* **Near-zero cost when off.**  ``span()`` on a disabled tracer returns a
  shared no-op context manager: one branch + one ``with`` per site.

* **Host CPU time beside wall time.**  Each record carries ``cpu_us``, the
  thread's CPU time over the span (``time.thread_time_ns``), beside its
  wall-clock ``dur_us``: a span whose wall time exceeds its CPU time had
  its thread waiting (on the card, the OS, a lock or the scheduler) rather
  than working.

* **Profiler bridge.**  ``Tracer(profiler=True)`` additionally enters a
  ``torch.profiler.record_function`` per span, so host spans land in
  ``torch.profiler`` traces beside the kernels they launch, in a trace
  that records CPU activity: the batched sweep's spans
  (``core.sim_batched.simulate_batch``) land there as ranges of their
  names.  A trace of CUDA activity alone keeps no range: there a caller
  puts the records' ``t0`` and ``dur_us`` (``perf_counter``) on the
  trace's clock itself, to name each idle gap of the card by the span the
  host was in.

Span records are plain dicts (``records()`` / ``to_json(path)``); the
structural view for equality testing is ``signature()`` — (trace, span,
parent, name, attrs) tuples with all timing stripped.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

TRACE_SCHEMA_VERSION = 1

ROOT_TRACE = -1   # trace id of spans opened before any begin_trace()


def block_ready(x):
    """Wait for every card that holds a tensor of ``x`` (a tensor, or a
    tuple or list of them); identity for host values.  Returns ``x``."""
    items = x if isinstance(x, (tuple, list)) else (x,)
    for dev in {t.device for t in items
                if isinstance(t, torch.Tensor) and t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return x


class _NullSpan:
    """Shared no-op context manager returned by disabled tracers.  One
    instance, no per-call allocation."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One open span; closes (and records itself) on ``__exit__``."""

    __slots__ = ("tracer", "name", "attrs", "trace_id", "span_id",
                 "parent_id", "t0", "c0", "_annotation")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self._annotation = None

    def __enter__(self):
        tr = self.tracer
        self.trace_id = tr._trace_id
        self.span_id = tr._next_span
        tr._next_span += 1
        self.parent_id = tr._stack[-1].span_id if tr._stack else None
        tr._stack.append(self)
        if tr.profiler:
            self._annotation = tr._annotation(self.name)
            if self._annotation is not None:
                self._annotation.__enter__()
        # the CPU-time interval nests inside the wall-clock one
        self.t0 = time.perf_counter()
        self.c0 = time.thread_time_ns()
        return self

    def __exit__(self, *exc):
        c1 = time.thread_time_ns()
        t1 = time.perf_counter()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        tr = self.tracer
        # a crash inside a child may unwind out of order; pop to this span
        while tr._stack and tr._stack[-1] is not self:
            tr._stack.pop()
        if tr._stack:
            tr._stack.pop()
        tr.spans.append({
            "trace": self.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "t0": self.t0,
            "dur_us": (t1 - self.t0) * 1e6,
            "cpu_us": (c1 - self.c0) / 1e3,
            "attrs": self.attrs,
        })
        return False


class Tracer:
    """Span collector with deterministic ids (module docstring).

    ``enabled=False`` (the engines' default) makes every method a cheap
    no-op; flip at construction, not mid-run — span ids are only meaningful
    for a consistent setting.
    """

    def __init__(self, enabled: bool = True, *, profiler: bool = False):
        self.enabled = enabled
        self.profiler = profiler and enabled
        self.spans: list[dict] = []
        self._trace_id: int = ROOT_TRACE
        self._next_span: int = 0
        self._stack: list[_Span] = []

    # ---- recording ---------------------------------------------------------

    def begin_trace(self, trace_id: int) -> None:
        """Start a new trace: subsequent spans carry ``trace_id`` and span
        ids restart from 0.  The engine calls this with the processed-event
        index, which is what makes replayed suffixes re-emit identical
        ids."""
        if not self.enabled:
            return
        self._trace_id = trace_id
        self._next_span = 0
        self._stack.clear()

    def span(self, name: str, **attrs):
        """Context manager for one span.  Attrs must be deterministic
        (model ids, shard counts, event kinds — never wall-clock values):
        they are part of the replay-equality signature."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def sync(self, x):
        """Block on device work before the enclosing span closes (enabled),
        or pass through untouched (disabled).  Values are identical either
        way — tracing never changes a decision."""
        if self.enabled:
            return block_ready(x)
        return x

    @property
    def current_trace(self) -> int | None:
        """The trace id stamped into EventLog processed records (None when
        disabled — records keep their untraced 4-field shape)."""
        return self._trace_id if self.enabled else None

    def _annotation(self, name: str):
        return torch.profiler.record_function(name)

    # ---- export ------------------------------------------------------------

    def records(self) -> list[dict]:
        """Finished spans, in completion order (children before parents)."""
        return list(self.spans)

    def signature(self, min_trace: int | None = None) -> list[tuple]:
        """Structural view for equality tests: (trace, span, parent, name,
        sorted attr items), timing stripped.  ``min_trace`` keeps only
        traces with id >= it — the replayed-suffix comparison."""
        out = []
        for s in self.spans:
            if min_trace is not None and s["trace"] < min_trace:
                continue
            out.append((s["trace"], s["span"], s["parent"], s["name"],
                        tuple(sorted(s["attrs"].items()))))
        return out

    def to_json(self, path: str | Path) -> Path:
        path = Path(path)
        path.write_text(json.dumps(
            {"schema_version": TRACE_SCHEMA_VERSION, "spans": self.spans},
            indent=2, sort_keys=True, allow_nan=False))
        return path


NULL_TRACER = Tracer(enabled=False)

__all__ = ["Tracer", "NULL_TRACER", "ROOT_TRACE", "block_ready",
           "TRACE_SCHEMA_VERSION"]
