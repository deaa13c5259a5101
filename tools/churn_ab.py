#!/usr/bin/env python3
"""Compares two checkouts on chip_smoke.py's churn trace, run (a), on one card.

    python3 tools/churn_ab.py PARENT_DIR [--rounds 3]

PARENT_DIR is another checkout of the repository (for example the parent
commit unpacked with ``git archive``); the checkout this script sits in is
the change.  Each side runs run (a) of ``chip_smoke.py``'s
``churn_sharded`` phase (100 tenants of 50 models, the open-world plane
sharded over 4 logical shards on the card, route ``eirate_topk``, a
retire + arrival + compaction every 10 decisions, reshard 4 -> 2 -> 4,
1,000 decisions) in a process of its own, importing that checkout's
``chip_smoke.py`` and ``src/`` and building its kernels into that
checkout's ``build/``.  The sides alternate (parent, change, change,
parent) over ``--rounds`` rounds.  Prints one JSON line per run (mean
decision ms on the host clock, each decision ending in a synchronize, and
the top-k launches), one with the medians and the picks' agreement, then
the card's name and power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# one run (a) of churn_sharded in the checkout at sys.argv[1]
RUN_A = """
import hashlib, json, sys
from pathlib import Path
root = Path(sys.argv[1]).resolve()
sys.path[:0] = [str(root), str(root / "src")]
import numpy as np, torch
import chip_smoke as cs
from repro_torch.core import ControlPlane
from repro_torch.core.tenancy import _matern_block_chol, _matern_draw
from repro_torch.kernels import ei_score, gp_readout
dev = torch.device("cuda")
counters = {"eirate": (ei_score, "launches"), "eirate_topk": (ei_score, "topk_launches"),
            "eirate_classes": (ei_score, "classes_launches"),
            "gp_readout": (gp_readout, "launches")}
plane = ControlPlane(np.random.default_rng(0), scorer="sharded", num_shards=4,
                     shard_topk=cs.TOPK, score_kernel="eirate_topk",
                     model_capacity=1024, tenant_capacity=16, device=dev)
picks, rec = cs.churn_trace(plane, cs.CHURN_DECISIONS, 0, _matern_block_chol,
                            _matern_draw, counters, torch.cuda.synchronize)
print(json.dumps(dict(mean_decision_ms=rec["mean_decision_ms"],
                      topk_launches=rec["launches"]["eirate_topk"],
                      picks_sha=hashlib.sha256(repr(picks).encode()).hexdigest())))
"""


def run(checkout: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN_A, str(checkout)],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"run (a) in {checkout} failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    sides = {"parent": args.parent.resolve(), "change": ROOT}
    runs: dict[str, list[dict]] = {"parent": [], "change": []}
    for _ in range(args.rounds):
        for side in ("parent", "change", "change", "parent"):
            rec = run(sides[side])
            runs[side].append(rec)
            print(json.dumps(dict(side=side, **rec)), flush=True)
    shas = {r["picks_sha"] for side in runs.values() for r in side}
    medians = {side: statistics.median(r["mean_decision_ms"] for r in rs)
               for side, rs in runs.items()}
    print(json.dumps(dict(median_mean_decision_ms=medians,
                          change_minus_parent_ms=medians["change"] - medians["parent"],
                          picks_equal=len(shas) == 1)), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0 if len(shas) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
