"""What a traced run reads from the device and the dispatcher: the aten
operations a call dispatches on the device (a ``TorchDispatchMode``), and
one call under ``torch.profiler`` reduced to busy time, kernel time, the
device operations that took most time and the longest idle gaps, each
gap named by the CUDA call the host was in at its middle (if any) and by
where it starts in the call.  The profiler records the device's activity and the
host's CUDA calls only: recording every aten operation as well slowed the
host's step loop by half and its post-processing took longer than the call.

Busy time is the union of the device's kernel, copy and set intervals; on
the one stream the sweep uses it equals their summed durations (as
``tools/profile_decision.py`` computes it).  The profiler is known to drop
records, whole windows of them, host and device records alike, so a
trace is not checked against itself alone: calls of one run launch the
same work, and a call's trace is read only when its device records number
exactly those of another call traced in a session of its own, and every
launch in it has its kernel record.  Up to ``ATTEMPTS`` calls are traced
(a system may ask for more); if no two agree, the run fails rather than
read a partial share.  A traced window may idle for ``pad_s`` before its
first marker and after its last.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx"})
NAME_CHARS = 120
TOP = 10
ATTEMPTS = 3


class DroppedRecords(RuntimeError):
    """No two traced calls kept the same, complete, device records."""


class _OpCounter(TorchDispatchMode):
    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type
        self.count = 0
        self.backward = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        first = out[0] if isinstance(out, (tuple, list)) and out else out
        if not isinstance(first, torch.Tensor):
            first = next((a for a in args if isinstance(a, torch.Tensor)), None)
        if first is not None and first.device.type == self.device_type:
            self.count += 1
            self.backward += "backward" in func.__name__
        return out


def count_ops_with_backward(fn, device_type: str = "cuda"):
    """``count_ops``, and of those operations the ones named as a backward
    formula (``silu_backward``, ...): a training step's backward pass is
    counted only if autograd's operations reach the mode."""
    with _OpCounter(device_type) as counter:
        out = fn()
    return out, counter.count, counter.backward


def count_ops(fn, device_type: str = "cuda"):
    """``(fn(), number of aten operations whose first output (or, with no
    tensor output, first tensor argument) is on device_type)``."""
    return count_ops_with_backward(fn, device_type)[:2]


def _merge(intervals: np.ndarray) -> np.ndarray:
    """Union of (start, end) rows, sorted, as disjoint rows."""
    if not len(intervals):
        return intervals
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.r_[True, iv[1:, 0] > reach[:-1]]
    starts = iv[new, 0]
    ends = np.r_[reach[np.flatnonzero(new)[1:] - 1], reach[-1]]
    return np.stack([starts, ends], 1)


def summarize(events, window_s: float, span: str) -> dict:
    """Reduce the profiler's records of one call, marked by the user range
    ``span``, to the traced run's device readings."""
    dev_iv, kernel_s, launches, kernels = [], 0.0, 0, 0
    by_name: dict[str, float] = defaultdict(float)
    kernel_by_name: dict[str, float] = defaultdict(float)
    host_iv, host_names, window = [], [], None
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            name, start, dur = e.name(), e.start_ns(), e.duration_ns()
            if name == span:        # the range's own mark on the device's timeline
                continue
            dev_iv.append((start, start + dur))
            by_name[name[:NAME_CHARS]] += dur / 1e9
            if not name.startswith(("Memcpy", "Memset")):
                kernel_s += dur / 1e9
                kernels += 1
                kernel_by_name[name[:NAME_CHARS]] += dur / 1e9
            continue
        name = e.name()
        if name == span:
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
            continue
        launches += name in LAUNCHES
        host_iv.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        host_names.append(name)
    busy = _merge(np.asarray(dev_iv, np.int64))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e9
    host = np.asarray(host_iv, np.int64).reshape(-1, 2)
    lo, hi = window if window else (host[:, 0].min(), host[:, 1].max())
    edges = np.r_[lo, busy.ravel(), hi]
    gaps = np.stack([edges[0::2], edges[1::2]], 1)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    longest = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")[:TOP]]
    idle = []
    for g0, g1 in longest:
        mid = (g0 + g1) // 2
        inside = np.flatnonzero((host[:, 0] <= mid) & (mid < host[:, 1]))
        label = host_names[inside[np.argmax(host[inside, 0])]] if len(inside) else "host, no CUDA call"
        idle.append([f"{label}, from {(g0 - lo) / 1e9:.1f} s of {(hi - lo) / 1e9:.1f} s",
                     float(g1 - g0) / 1e9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": window_s, "busy_s": busy_s, "kernel_s": kernel_s,
            "kernel_s_by_name": dict(kernel_by_name), "records": len(dev_iv), "kernels": kernels, "launches": launches,
            "breakdown": {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}}


def profile_call(fn, span: str = "sweep_call", pad_s: float = 0.0):
    """``(fn(), summary)`` of one call traced by ``torch.profiler`` (the
    device and the host's CUDA calls); ``window_s`` is the host clock
    around the call, which ends when the card is idle.  ``pad_s`` idles
    inside the profiler's window before the first marker and after the
    last, so that records whose mapped times stray a little off the host's
    clock stay inside it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        with record_function(span):
            # a launch before and after the call marks its extent among the
            # host's CUDA calls, where no host range is recorded
            mark = torch.zeros(1, device="cuda")
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
            mark.zero_()
            torch.cuda.synchronize()
        time.sleep(pad_s)
    return out, summarize(prof.profiler.kineto_results.events(), window_s, span)


def profile_agreed(fn, attempts: int = ATTEMPTS, span: str = "sweep_call",
                   pad_s: float = 0.0):
    """``profile_call(fn)`` repeated until a call's trace keeps a kernel
    record for every launch and as many device records as an earlier
    call's trace: ``(fn(), summary, device records of every traced call)``."""
    seen = []
    padding = {"pad_s": pad_s} if pad_s else {}
    for _ in range(attempts):
        out, summary = profile_call(fn, span, **padding)
        records = summary["records"]
        complete = summary["launches"] > 0 and summary["kernels"] >= summary["launches"]
        if complete and records in seen:
            return out, summary, seen + [records]
        seen.append(records)
        del out
    raise DroppedRecords(f"device records of {attempts} traced calls: {seen}")
