#!/usr/bin/env python3
"""Times the EIrate and class-axis EIrate kernels alone over membership
layouts at service size, on one CUDA card.

    python3 tools/ei_profile.py

Builds the kernels (``_build``) and ``chip_smoke.py``'s FP64 probe, then at
N 1,000 tenants, n 100,000 models (the class-axis kernel at C 4), inputs
made from a seed as ``chip_smoke.py`` makes them, prints one JSON line per
layout: each kernel bit-equal to its plain version, its mean device ms
under torch.profiler, and the bound of those inputs (bytes, or the FP64
instructions their terms execute, counted by the probe).  The layouts take
the terms apart:

  disjoint     one owner a model: the walk and the bytes alone
  dense        40% random membership, sigma mixed: the erf and erfc
               branches of ndtr in one warp
  dense_erf    the same membership, sigma 100: every term on the erf branch
  dense_erfc   sigma 0.1 and mu - best_i from 0.3 to 0.5: every term on the
               erfc branch
  dense_sigma0 sigma 0: every term max(mu - best_i, 0), no FP64 work, so
               the walk, the dealing and the adds alone

Then the card's name and power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch import _build  # noqa: E402
from repro_torch.kernels import ei_score, ref  # noqa: E402

N, n, C = 1000, 100_000, 4
LAYOUTS = ("disjoint", "dense", "dense_erf", "dense_erfc", "dense_sigma0")


def inputs(layout, rng, dev):
    args = chip_smoke.ei_inputs(N, n, "disjoint" if layout == "disjoint"
                                else "dense", rng, dev)
    mu, sg, best = args[:3]
    if layout == "dense_erf":
        sg.fill_(100.0)
    elif layout == "dense_erfc":
        mu.fill_(0.0)
        sg.fill_(0.1)
        best.copy_(torch.from_numpy(
            rng.uniform(-0.5, -0.3, N).astype(np.float32)).to(dev))
    elif layout == "dense_sigma0":
        sg.fill_(0.0)
    return args


def main() -> int:
    if not torch.cuda.is_available():
        print("ei_profile: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    _build.build(["ei_score", "ei_classes", "ei_topk"])
    fp64 = chip_smoke.fp64_probe(_build)
    print(json.dumps(dict(fp64_instructions=fp64)), flush=True)
    rng = np.random.default_rng(0)
    for layout in LAYOUTS:
        args = inputs(layout, rng, dev)
        mu, sg, best, mem, cost, sel = args
        cm = torch.stack([cost * (c + 1) for c in range(C)])
        got, got_c = ei_score.eirate(*args), ei_score.eirate_classes(
            mu, sg, best, mem, cm, sel)
        chip_smoke.check(
            torch.equal(got, ref.eirate_ref(*args)) and torch.equal(
                got_c, ref.eirate_classes_ref(mu, sg, best, mem, cm, sel)),
            f"ei_profile {layout}: a kernel differs from its plain version")
        pairs, fp64, b_ms, b_by = chip_smoke.ei_bound(args)
        _, _, bc_ms, bc_by = chip_smoke.classes_bound([mu, sg, best, mem, cm, sel])
        print(json.dumps(dict(
            layout=layout, N=N, n=n, C=C, member_pairs=pairs,
            member_pairs_sigma_pos=int(mem[:, sg > 0].sum()),
            fp64_instructions=fp64,
            eirate_kernel_ms=chip_smoke.device_ms(
                lambda: ei_score.eirate(*args), "eirate_kernel", 20),
            eirate_bound_ms=b_ms, eirate_bound_by=b_by,
            classes_kernel_ms=chip_smoke.device_ms(
                lambda: ei_score.eirate_classes(mu, sg, best, mem, cm, sel),
                "eirate_classes_kernel", 20),
            classes_bound_ms=bc_ms, classes_bound_by=bc_by)), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
