"""Device-time attribution: capture windows, shard skew, dispatch cost.

The port's counterpart of ``repro.obs.profile``, on PyTorch.  Where
``obs/accounting.py`` answers *where the bytes are*, this module answers
*where the device time goes* in the sharded decision:

* :func:`capture` — a ``torch.profiler`` window around any region, exported
  as a Chrome trace; the tracer's spans (``torch.profiler.record_function``
  when the tracer's bridge is on) and the phased decision's ``readout`` /
  ``score_topk`` / ``gather_pick`` spans land in it beside the kernels they
  launch.  A no-op context when ``logdir`` is None.
  :func:`capture_call` runs a callable in such windows and takes a window
  again when it kept no device record.
* :func:`per_shard_skew` — one caller-built thunk per device of a scoring
  mesh, timed in turn: the per-shard timing spread, on the same max/mean
  scale as ``ShardLayout.imbalance``.
* :func:`dispatch_overhead_us` — the fixed cost of the per-shard launch
  loop that ``shardgp.score.ShardedScorer`` runs (a launch on each shard's
  device, the copies of the candidates to ``mesh[0]``, the concatenation),
  with compute that rounds to zero.  The reference times a trivial
  ``shard_map`` program here; the port has no such program.

Everything here is host-side measurement machinery: nothing is wired into
the engines and nothing feeds a decision.

Profiler windows follow what runs on the card showed (PERF.md):
Kineto keeps only the device records whose timestamps, mapped to the
host's clock, fall inside the window, and that mapping can lie
milliseconds off; so each window idles ``PAD_S`` at both ends.  Some
windows still keep no device record at all; :func:`capture_call` retakes
them, up to ``ATTEMPTS`` windows.
"""

from __future__ import annotations

import contextlib
import time as _time
from pathlib import Path

import torch

from .trace import block_ready

PROFILE_SCHEMA_VERSION = 1

#: idle seconds at each end of a profiler window
PAD_S = 0.05
#: windows :func:`capture_call` takes before it gives up
ATTEMPTS = 5


def profiler_available() -> bool:
    """True when ``torch.profiler`` can trace a card here."""
    from torch.profiler import ProfilerActivity, supported_activities
    return (torch.cuda.is_available()
            and ProfilerActivity.CUDA in supported_activities())


class Window:
    """What :func:`capture` yields: the exported trace's ``path`` and, once
    the window has closed, ``device_events``, the number of device records
    it kept (0 for a window that captured nothing)."""

    def __init__(self, path: Path | None):
        self.path = path
        self.device_events = 0

    def __bool__(self) -> bool:
        return self.path is not None


@contextlib.contextmanager
def capture(logdir: str | Path | None = None, name: str = "trace.json"):
    """``torch.profiler`` window (host and card activity) around the body,
    exported as a Chrome trace to ``logdir / name``.  The window idles
    ``PAD_S`` at each end, the closing one after a synchronize.  Yields a
    :class:`Window`, falsy when ``logdir`` is None (then nothing is
    profiled) and when the profiler cannot trace a card."""
    if logdir is None or not profiler_available():
        yield Window(None)
        return
    from torch.profiler import ProfilerActivity, profile
    path = Path(logdir) / name
    path.parent.mkdir(parents=True, exist_ok=True)
    win = Window(path)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _time.sleep(PAD_S)
        yield win
        torch.cuda.synchronize()
        _time.sleep(PAD_S)
    win.device_events = sum(
        1 for e in prof.events()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    prof.export_chrome_trace(str(path))


def capture_call(fn, logdir: str | Path, *, iters: int = 1,
                 attempts: int = ATTEMPTS) -> dict:
    """``iters`` calls of ``fn`` (after one warm-up call) inside a
    :func:`capture` window; a window that kept no device record is taken
    again, up to ``attempts`` windows.  Returns the trace's path, the
    windows taken and the device records the last one kept."""
    if not profiler_available():
        raise RuntimeError("torch.profiler cannot trace a card here")
    block_ready(fn())
    torch.cuda.synchronize()
    for window in range(1, attempts + 1):
        with capture(logdir) as win:
            for _ in range(iters):
                fn()
        if win.device_events:
            break
        _time.sleep(0.2 * window)   # the drops come in runs: let one pass
    return {"schema_version": PROFILE_SCHEMA_VERSION, "path": str(win.path),
            "windows": window, "device_events": win.device_events}


def wait(out) -> None:
    """Wait for the cards that hold ``out``'s tensors, and for the current
    card once CUDA is in use (work whose result is a host value)."""
    block_ready(out)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_us_blocked(fn, *, iters: int = 10, warmup: int = 2) -> float:
    """Mean host-clock µs per call, each call followed by a synchronize of
    the cards that hold its outputs (and the current card): asynchronous
    launches must not let timings overlap."""
    for _ in range(warmup):
        wait(fn())
    t0 = _time.perf_counter()
    for _ in range(iters):
        wait(fn())
    return (_time.perf_counter() - t0) / iters * 1e6


def per_shard_skew(make_thunk, devices, *, iters: int = 10,
                   warmup: int = 2) -> dict:
    """Per-device timing spread of one shard's workload.

    ``make_thunk(shard_index, device)`` builds a zero-argument callable that
    runs that shard's slice of work on ``device`` (state is built inside
    the builder, outside the timed region); ``devices`` is a scoring mesh
    (``ShardedScorer.mesh``: one entry per shard, several may name one
    card).  Returns the per-shard µs and the max/mean skew index."""
    per = [time_us_blocked(make_thunk(s, torch.device(dev)), iters=iters,
                           warmup=warmup)
           for s, dev in enumerate(devices)]
    mean = sum(per) / len(per)
    return {"schema_version": PROFILE_SCHEMA_VERSION,
            "per_shard_us": per,
            "mean_us": mean, "max_us": max(per), "min_us": min(per),
            "skew": max(per) / mean if mean > 0 else 1.0}


def dispatch_overhead_us(devices, *, iters: int = 50,
                         warmup: int = 5) -> float:
    """Per-call cost of the sharded scorer's launch loop over ``devices``
    (a scoring mesh): one add on a one-element tensor on each shard's
    device, the results copied to ``devices[0]`` in shard order and
    concatenated, as ``ShardedScorer`` gathers its candidates.  The compute
    rounds to zero, so what is measured is the launches, the copies and the
    synchronize that every sharded decision pays whatever its size."""
    devices = [torch.device(d) for d in devices]
    home = devices[0]
    xs = [torch.zeros(1, dtype=torch.float32, device=d) for d in devices]

    def loop():
        return torch.cat([(x + 1.0).to(home) for x in xs])

    return time_us_blocked(loop, iters=iters, warmup=warmup)


__all__ = ["capture", "capture_call", "profiler_available", "time_us_blocked", "wait",
           "per_shard_skew", "dispatch_overhead_us", "Window",
           "PROFILE_SCHEMA_VERSION", "PAD_S", "ATTEMPTS"]
