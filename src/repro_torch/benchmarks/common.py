"""Shared utilities of the port's paper-figure drivers: CSV rows, engine
flags, the suite record and its environment stamp.

Every driver prints rows:  name,us_per_call,derived
(one logical row per paper-figure entry; ``derived`` packs the figure of
merit as ``key=value`` pairs joined by ``;``), in the JAX drivers' format,
so the two outputs can be diffed line by line.

The drivers accept ``--engine {event,batched}`` as the JAX drivers do.
``event`` is the host event loop of ``repro_torch.core.simulate``.
``batched`` raises ``NotImplementedError``: the batched sweep engine is not
ported yet (ROADMAP.md section 1, item 7).

``us_per_call`` is ``SimResult.decision_seconds`` per decision.  Each
decision's clock stops once its pick is a Python int on the host, a read
that waits for the card, so the time covers the decision's device work;
:func:`episode` ends each episode in a ``torch.cuda.synchronize()``, so no
episode's device work runs on into the next one's clock.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..core import simulate
from ..device import resolve

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


def require_event_engine(engine: str) -> None:
    """Raise for ``--engine batched`` (never a silent fall back to event)."""
    if engine != "event":
        raise NotImplementedError(
            "--engine batched needs the batched sweep engine, which is not "
            "ported yet (ROADMAP.md section 1, item 7); use --engine event")


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


def emit(name: str, us_per_call: float, **derived) -> None:
    packed = ";".join(f"{k}={v}" for k, v in derived.items())
    print(f"{name},{us_per_call:.1f},{packed}")
    if _suite_rows is not None:
        _suite_rows[name] = {"us_per_call": round(us_per_call, 1),
                             **{k: str(v) for k, v in derived.items()}}
