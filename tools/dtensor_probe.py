#!/usr/bin/env python3
"""Which dry-run cells trace on this machine's torch.

    python3 tools/dtensor_probe.py

The sharded route of the models (``repro_torch.sharding``) leans on
DTensor, whose rules differ between torch releases.  This script traces,
one process each, seven at a time: every family's smoke config at train,
prefill and decode on a fake 2 x 4 mesh (DEFAULT_RULES; FSDP and PUREDP on
qwen3-4b and qwen3-moe, QROWS on musicgen, mamba2's long decode), and the
five full-shape cells of ``chip_smoke.py``'s ``launch`` phase on the fake
256-rank mesh (``python -m repro_torch.launch.dryrun --probe``).  Prints
torch's version, then one JSON line a cell: its exit code, wall seconds,
and for a failure the error and the last frames.  Needs no card (the
fake process group); writes ``chiprun_out/dtensor_probe.json`` and the
full cells' records under ``experiments/dryrun_torch/``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SMOKE_CELL = r'''
import json, logging, sys, traceback
logging.disable(logging.WARNING)
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.sharding import rules as R
arch, kind, rules = sys.argv[1], sys.argv[2], sys.argv[3]
dryrun.init_fake_world(8)
try:
    with dryrun.extra_shape("tiny", 64, 8 if kind != "long_decode" else 1, kind) as s:
        _, c, secs = dryrun.count_cell(get_smoke_config(arch), s, make_test_mesh(2, 4),
                                       getattr(R, rules))
    print(json.dumps(dict(ok=True, flops=c["flops"], records=len(c["records"]), s=secs)))
except Exception as e:
    tb = traceback.format_exc()
    print(json.dumps(dict(ok=False, err=(type(e).__name__ + ": " + str(e))[-600:],
                          where=[l for l in tb.splitlines() if "File" in l][-8:])))
'''
FAMILIES = ("qwen3-4b", "mamba2-1.3b", "zamba2-2.7b", "qwen3-moe-235b-a22b",
            "paligemma-3b", "musicgen-medium", "h2o-danube-3-4b")
FULL = (("qwen3-8b", "train_4k", "default"), ("musicgen-medium", "prefill_32k", "qrows"),
        ("mamba2-1.3b", "long_500k", "default"), ("arctic-480b", "train_4k", "fsdp"),
        ("qwen3-8b", "train_4k", "puredp"))


def jobs():
    out = [("full", *cell) for cell in FULL]
    out += [("smoke", a, k, "DEFAULT_RULES") for a in FAMILIES
            for k in ("train", "prefill", "decode")]
    for arch in ("qwen3-4b", "qwen3-moe-235b-a22b"):
        out += [("smoke", arch, "train", "FSDP_RULES"), ("smoke", arch, "train", "PUREDP_RULES")]
    out += [("smoke", "musicgen-medium", "prefill", "QROWS_RULES"),
            ("smoke", "mamba2-1.3b", "long_decode", "DEFAULT_RULES")]
    return out


def run(job, env):
    t0 = time.time()
    if job[0] == "smoke":
        cmd, timeout = [sys.executable, "-c", SMOKE_CELL, *job[1:]], 300
    else:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", job[1],
               "--shape", job[2], "--rules", job[3], "--probe"]
        timeout = 900
    try:
        p = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                           timeout=timeout)
    except subprocess.TimeoutExpired:
        return dict(job=job, rc="timeout", wall=time.time() - t0)
    last = p.stdout.strip().splitlines()[-1:] if p.stdout.strip() else []
    tail = (p.stdout + p.stderr)[-1500:] if p.returncode or job[0] == "full" else ""
    return dict(job=job, rc=p.returncode, out=last, tail=tail, wall=time.time() - t0)


def main() -> int:
    import torch

    print(json.dumps(dict(torch=torch.__version__, cuda=torch.version.cuda)), flush=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    with ThreadPoolExecutor(7) as ex:
        res = list(ex.map(lambda j: run(j, env), jobs()))
    for r in res:
        print(json.dumps(r)[:2500], flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "dtensor_probe.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
