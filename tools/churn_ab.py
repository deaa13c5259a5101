#!/usr/bin/env python3
"""Compares two checkouts on three of chip_smoke.py's paths, on one card.

    python3 tools/churn_ab.py PARENT_DIR [--rounds 3]

PARENT_DIR is another checkout of the repository (for example the parent
commit unpacked with ``git archive``); the checkout this script sits in is
the change.  Each run takes, in a process of its own that imports that
checkout's ``chip_smoke.py`` and ``src/`` and builds its kernels into that
checkout's ``build/``:

  churn    run (a) of ``churn_sharded``: 100 tenants of 50 models, the
           open-world plane sharded over 4 logical shards on the card,
           route ``eirate_topk``, a retire + arrival + compaction every 10
           decisions, reshard 4 -> 2 -> 4, 1,000 decisions; mean decision
           ms (host clock, each decision ending in a synchronize)
  devplane run (a) of ``devplane_churn``: the device plane through the
           400-session tenant + device churn trace, batched assignment,
           scorer ops, the class-axis EIrate kernel once a scoring pass;
           mean decision ms per policy launch
  fig5     the Fig-5 episode (50 tenants x 50 models, mdmt, M = 4, horizon
           600): the EIrate kernel once a decision; mean decision ms

Each side runs once first as a warm-up, printed and left out (a fresh
machine's first process runs several times slower).  Then the sides
alternate (parent, change, change, parent) over ``--rounds`` rounds, each
round two pairs.  Prints one JSON line per run (the three means, the
launches, and a hash of each path's picks or trials), then for each path
the medians, the distance between the parent's quartiles (its spread),
the pairs the change won, and whether both sides picked alike, then the
card's name and power limit as ``nvidia-smi`` reports them.  Exits 1 if
the two sides' picks differ.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PATHS = ("churn", "devplane", "fig5")

# the three paths in the checkout at sys.argv[1]
RUN = """
import dataclasses, hashlib, json, sys
from pathlib import Path
root = Path(sys.argv[1]).resolve()
sys.path[:0] = [str(root), str(root / "src")]
import numpy as np, torch
import chip_smoke as cs
from repro_torch import stream
from repro_torch.core import ControlPlane, simulate, synthetic_matern_problem
from repro_torch.core.tenancy import _matern_block_chol, _matern_draw
from repro_torch.devplane import DevPlaneEngine, two_class_registry
from repro_torch.kernels import ei_score, gp_readout
dev = torch.device("cuda")
sha = lambda x: hashlib.sha256(repr(x).encode()).hexdigest()
counters = {"eirate": (ei_score, "launches"), "eirate_topk": (ei_score, "topk_launches"),
            "eirate_classes": (ei_score, "classes_launches"),
            "gp_readout": (gp_readout, "launches")}
def reset():
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
def read():
    return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
out = {}
plane = ControlPlane(np.random.default_rng(0), scorer="sharded", num_shards=4,
                     shard_topk=cs.TOPK, score_kernel="eirate_topk",
                     model_capacity=1024, tenant_capacity=16, device=dev)
picks, rec = cs.churn_trace(plane, cs.CHURN_DECISIONS, 0, _matern_block_chol,
                            _matern_draw, counters, torch.cuda.synchronize)
out["churn"] = dict(ms=rec["mean_decision_ms"], launches=rec["launches"], sha=sha(picks))
reg = two_class_registry(2.0, overhead=0.5)
eng = DevPlaneEngine(reg.build_fleet(list(cs.DEVPLANE_FLEET)), "mdmt", seed=0,
                     registry=reg, launch_order="fastest",
                     max_live_models=cs.DEVPLANE_MAX_LIVE,
                     num_shards=cs.DEVPLANE_SHARDS, device=dev)
reset()
res = eng.run(stream.device_churn_trace(**cs.DEVPLANE_TRACE))
torch.cuda.synchronize()
out["devplane"] = dict(ms=res.decision_seconds / max(res.policy_launches, 1) * 1e3,
                       policy_launches=res.policy_launches, launches=read(),
                       sha=sha([dataclasses.astuple(t) for t in res.trials]))
reset()
r = simulate(synthetic_matern_problem(50, 50, seed=0), "mdmt", num_devices=4,
             seed=0, horizon=cs.FIG5_HORIZON, device="cuda")
torch.cuda.synchronize()
out["fig5"] = dict(ms=r.decision_seconds / max(r.decisions, 1) * 1e3,
                   decisions=r.decisions, launches=read(), sha=sha(r.trials))
print(json.dumps(out))
"""


def run(checkout: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN, str(checkout)],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"the runs in {checkout} failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    sides = {"parent": args.parent.resolve(), "change": ROOT}
    runs: dict[str, list[dict]] = {"parent": [], "change": []}
    for side in sides:
        print(json.dumps(dict(side=side, warmup=True, **run(sides[side]))),
              flush=True)
    for _ in range(args.rounds):
        for side in ("parent", "change", "change", "parent"):
            rec = run(sides[side])
            runs[side].append(rec)
            print(json.dumps(dict(side=side, **rec)), flush=True)
    same = {path: len({r[path]["sha"] for rs in runs.values() for r in rs}) == 1
            for path in PATHS}
    summary = {}
    for path in PATHS:
        ms = {side: [r[path]["ms"] for r in rs] for side, rs in runs.items()}
        q = statistics.quantiles(ms["parent"], n=4)
        med = {side: statistics.median(v) for side, v in ms.items()}
        summary[path] = dict(
            median_ms=med, change_minus_parent_ms=med["change"] - med["parent"],
            parent_quartile_spread_ms=q[2] - q[0],
            change_wins=sum(c < p for p, c in zip(ms["parent"], ms["change"])),
            pairs=len(ms["parent"]), picks_equal=same[path])
    print(json.dumps(summary), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
