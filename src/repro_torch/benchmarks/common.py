"""Shared utilities of the port's benchmark sections: CSV rows, engine
flags, timing, the suite record and its environment stamp.

Every section prints rows:  name,us_per_call,derived
(one logical row per table entry; ``derived`` packs the figure of merit as
``key=value`` pairs joined by ``;``), in the JAX package's format, so the
two outputs can be diffed line by line.

The paper-figure drivers accept ``--engine {event,batched}`` as the JAX
drivers do.  ``event`` is the host event loop of
``repro_torch.core.simulate``: a figure's ``us_per_call`` is then
``SimResult.decision_seconds`` per decision.  Each decision's clock stops
once its pick is a Python int on the host, a read that waits for the card,
so the time covers the decision's device work; :func:`episode` ends each
episode in a ``torch.cuda.synchronize()``, so no episode's device work runs
on into the next one's clock.  ``batched`` runs the episodes through
``repro_torch.core.simulate_batch`` (DESIGN.md §6); its rows carry
``engine=batched`` and their ``us_per_call`` is a batch's wall clock per
episode (``BatchResult.wall_seconds``, which ends when the logs are on the
host), not a decision's latency.

The service suites time with :func:`time_us` and :func:`timed`, which wait
for the card (``obs.profile.wait``): ``sync=True`` after every call, else
once after the loop.  Each section reads :data:`FAST` when it runs, so
:func:`set_fast` takes effect whenever it is called.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

from ..core import simulate
from ..device import resolve
from ..obs.profile import time_us_blocked, wait

FAST = os.environ.get("BENCH_FAST", "0") == "1"

# Version of the BENCH_<suite>.json payload shape; the JAX drivers' version 1:
#   {"schema_version", "git_sha", "suite", "environment", "rows": {name: {...}}}
BENCH_SCHEMA_VERSION = 1


def set_fast(value: bool = True) -> None:
    """Flip FAST at runtime (``run --smoke``).  Must run before the figure
    modules are imported: they bind ``FAST`` at import time."""
    global FAST
    FAST = value
    os.environ["BENCH_FAST"] = "1" if value else "0"


def episode(problem, policy: str, num_devices: int, seed: int, device=None):
    """One ``repro_torch.core.simulate`` episode on ``device`` (None: the
    card), synchronized with the card before it returns."""
    res = simulate(problem, policy, num_devices=num_devices, seed=seed,
                   device=device)
    if resolve(device).type == "cuda":
        torch.cuda.synchronize()
    return res


def git_sha() -> str:
    """Short git SHA of the checkout (env override GIT_SHA for detached
    states), or "unknown" outside a repo."""
    sha = os.environ.get("GIT_SHA")
    if sha:
        return sha[:12]
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            cwd=Path(__file__).resolve().parent, capture_output=True,
            text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip() if out.returncode == 0 else "unknown"


def environment() -> dict:
    """The measurement environment stamp that rides in every BENCH payload:
    the JAX drivers' fields, with the device read from ``torch.cuda`` and,
    where ``nvidia-smi`` exists, the card's driver version and power limit
    (a card set below its maximum runs slower under load).  Without a card
    the device fields are "none" and 0, so the stamp never fails a suite."""
    import platform
    env = {
        "platform": platform.system().lower() or "unknown",
        "machine": platform.machine() or "unknown",
        "python": platform.python_version(),
        "fast": FAST,
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
        "device_kind": "none",
        "device_count": 0,
        "driver_version": "none",
        "power_limit": "none",
    }
    if not torch.cuda.is_available():
        return env
    env["device_kind"] = torch.cuda.get_device_name(0)
    env["device_count"] = torch.cuda.device_count()
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return env
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit,driver_version",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return env
    lines = out.stdout.strip().splitlines()
    if out.returncode == 0 and lines:
        fields = [f.strip() for f in lines[0].split(",")]
        if len(fields) == 3:
            env["power_limit"], env["driver_version"] = fields[1], fields[2]
    return env


# rows of the suite being recorded (None = recording off); run.py brackets
# each section with begin_suite()/end_suite()
_suite_name: str | None = None
_suite_rows: dict[str, dict] | None = None


def begin_suite(name: str) -> None:
    """Start recording emit() rows under suite ``name``."""
    global _suite_name, _suite_rows
    _suite_name = name
    _suite_rows = {}


def end_suite(out_dir: str | Path = ".") -> Path | None:
    """Write the recorded rows to BENCH_<suite>.json and stop recording.
    Returns the path (None if nothing was recorded)."""
    global _suite_name, _suite_rows
    name, rows = _suite_name, _suite_rows
    _suite_name = _suite_rows = None
    if name is None or rows is None:
        return None
    payload = {
        "schema_version": BENCH_SCHEMA_VERSION,
        "git_sha": git_sha(),
        "suite": name,
        "environment": environment(),
        "rows": rows,
    }
    path = Path(out_dir) / f"BENCH_{name}.json"
    path.write_text(json.dumps(payload, indent=2, sort_keys=True))
    return path


def abort_suite() -> None:
    """Stop recording without writing: a failed section writes no partial
    rows."""
    global _suite_name, _suite_rows
    _suite_name = _suite_rows = None


def positive_int(value: str) -> int:
    iv = int(value)
    if iv < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {iv}")
    return iv


def parse_engine_args(argv=None) -> argparse.Namespace:
    """Parse the shared --engine/--seeds flags.

    Tolerates bare section names (``run`` passes sys.argv through) but
    rejects unknown flags, so a typo'd option fails loudly, also when a
    figure module is run directly.
    """
    p = argparse.ArgumentParser(
        description="episode-engine selection (shared by fig2-5)")
    p.add_argument("--engine", choices=("event", "batched"), default="event")
    p.add_argument("--seeds", type=positive_int, default=None)
    # handled by run before the figure modules import; accepted here so the
    # flag survives the stray-flag check when argv passes through
    p.add_argument("--smoke", action="store_true")
    args, rest = p.parse_known_args(argv)
    if args.smoke and not FAST:
        # a standalone figure module binds FAST at import, before this parse
        p.error("--smoke only takes effect via `python -m "
                "repro_torch.benchmarks.run --smoke`; for a standalone figure "
                "module set BENCH_FAST=1")
    stray = [t for t in rest if t.startswith("-")]
    if stray:
        p.error(f"unrecognized arguments: {' '.join(stray)}")
    return args


def parse_rows(text: str) -> list[tuple[str, float, list]]:
    """The ``name,us_per_call,derived`` rows of ``text``, each as
    ``(name, us_per_call, [(key, value), ...])`` in the printed order.  A
    value may hold ``;`` itself (``capacity_shard_skew``'s list of
    per-shard times): a piece without ``=`` belongs to the value before."""
    rows = []
    for line in text.strip().splitlines():
        name, us, derived = line.split(",", 2)
        pairs = []
        for piece in derived.split(";") if derived else ():
            if "=" in piece:
                pairs.append(tuple(piece.split("=", 1)))
            else:
                pairs[-1] = (pairs[-1][0], f"{pairs[-1][1]};{piece}")
        rows.append((name, float(us), pairs))
    return rows


def capture_rows(fn, *args, **kw) -> list[tuple[str, float, list]]:
    """Runs ``fn(*args, **kw)`` with its standard output captured and
    returns the rows it printed (:func:`parse_rows`)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return parse_rows(buf.getvalue())


def emit(name: str, us_per_call: float, **derived) -> None:
    packed = ";".join(f"{k}={v}" for k, v in derived.items())
    print(f"{name},{us_per_call:.1f},{packed}")
    if _suite_rows is not None:
        _suite_rows[name] = {"us_per_call": round(us_per_call, 1),
                             **{k: str(v) for k, v in derived.items()}}


def time_us(fn, *args, iters: int = 20, warmup: int = 3, sync: bool = False,
            **kw) -> float:
    """Mean wall time of ``fn(*args, **kw)`` in µs, after ``warmup`` calls.

    By default the loop waits for the card once, after its last call: the
    steady-state throughput of an asynchronous pipeline.  ``sync=True``
    waits after every call (``obs.profile.time_us_blocked``), which is what
    a latency needs: each call's time includes its device work.  Either way
    the warm-up calls (lazy kernel builds, first library calls) finish
    before the clock starts."""
    if sync:
        return time_us_blocked(lambda: fn(*args, **kw), iters=iters,
                               warmup=warmup)
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    wait(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kw)
    wait(out)
    return (time.perf_counter() - t0) / iters * 1e6


def timed(fn, *args, **kw):
    """One call that waits for the card: ``(seconds, result)``.  For
    one-shot costs (a compaction pass, a whole engine run) where a loop
    would mutate state it should not."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    wait(out)
    return time.perf_counter() - t0, out


def run_standalone(suite: str, main, description: str) -> None:
    """``python -m repro_torch.benchmarks.<section> [--smoke]``: run one
    section on the card and write its ``BENCH_<suite>.json``."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--smoke", action="store_true",
                   help="toy shapes (same effect as BENCH_FAST=1)")
    if p.parse_args().smoke:
        set_fast(True)
    begin_suite(suite)
    try:
        main()
    except BaseException:
        abort_suite()
        raise
    path = end_suite()
    if path is not None:
        print(f"# wrote {path}", file=sys.stderr)


#: rounds over which :func:`interleaved` splits its loops
ROUNDS = 5


def interleaved(loops: dict, rounds: int = ROUNDS) -> dict:
    """Mean µs a call of each loop, the loops' calls interleaved in rounds.

    ``loops`` maps a name to ``(measure, iters)``: ``measure(k)`` times k
    calls and returns µs a call (a number, or a dict of numbers).  Each
    loop's ``iters`` calls are split over ``rounds`` rounds, and inside a
    round the loops run one after another, so timings that a bar holds
    against each other are taken under the same conditions of the host.
    The card's host runs the same Python up to 2x slower for stretches of
    tens to hundreds of milliseconds (PERF.md, PR 23, measured in a process
    that had not imported torch): loops run one after the other, as the
    reference runs them, would let one stretch decide such a bar.  The
    calls, and so each mean's expected value, are the same."""
    sums: dict = {}
    for r in range(rounds):
        for name, (measure, iters) in loops.items():
            k = iters // rounds + (r < iters % rounds)
            if k == 0:
                continue
            got = measure(k)
            if isinstance(got, dict):
                acc = sums.setdefault(name, dict.fromkeys(got, 0.0))
                for key, us in got.items():
                    acc[key] += us * k
            else:
                sums[name] = sums.get(name, 0.0) + got * k
    return {name: ({key: v / loops[name][1] for key, v in acc.items()}
                   if isinstance(acc, dict) else acc / loops[name][1])
            for name, acc in sums.items()}
