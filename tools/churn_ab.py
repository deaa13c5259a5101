#!/usr/bin/env python3
"""Compares two checkouts on chip_smoke.py's paths and kernels, on one card.

    python3 tools/churn_ab.py PARENT_DIR [--rounds 5] [--paths churn,devplane,...]

PARENT_DIR is another checkout of the repository (for example the parent
commit unpacked with ``git archive``); the checkout this script sits in is
the change.  Each run takes, in a process of its own that imports that
checkout's ``chip_smoke.py`` and ``src/`` and builds its kernels into that
checkout's ``build/``, the paths named in ``--paths`` (default all):

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
  readout  the GP readout kernel alone (device time under torch.profiler)
           at k 50, n 50 (the Fig-5 episode's blocks), k 200, n 2,048 (the
           dense episode), k 512, n 2,500, k 1,024, n 100,000 (service
           size) and k 1,024, n 25,000 as columns 25,000-50,000 of a
           100,000-column W (a shard's slice in ``readout_decide`` over 4
           shards); each checked bit-equal to ``ref.gp_readout_ref``
  flash    flash attention on float32 q, k, v at qwen3-4b's attention
           shape (B 2, S 2,048, 32/8 heads, D 128): the kernel alone and
           the wrapper's call (CUDA events), after holding it to
           ``ref.attention_ref`` at ``chip_smoke.DATA_TOL``;
           ``scaled_dot_product_attention`` on the same inputs (CUDA
           events); the kernel alone at the serve check's shape (B 1, S
           513)
  ssd      the SSD scan on float32 x, b, c at mamba2-1.3b's layer shape,
           B 2 (S 2,048, H 64, P 64, N 128, chunk 256): the route's kernels
           alone (the sum of their device times under torch.profiler) and
           the wrapper's call (CUDA events), after holding it to
           ``ref.ssd_ref`` at ``chip_smoke.DATA_TOL``; the kernels alone
           at the serve check's shape (B 1, S 513, one chunk of 513)

Each side runs once first as a warm-up, printed and left out (a fresh
machine's first process runs several times slower).  Then the sides
alternate (parent, change, change, parent) over ``--rounds`` rounds, each
round two pairs.  Prints one JSON line per run (each metric's ms, and for
the paths whose result both sides must share, a hash of the picks,
trials or outputs), then for each metric the medians, the distance
between the parent's quartiles (its spread), the pairs the change won,
and, where hashed, whether both sides gave the same result, then the
card's name and power limit as ``nvidia-smi`` reports them.  Exits 1 if
two hashed results differ.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PATHS = ("churn", "devplane", "fig5", "readout", "flash", "ssd")

# the paths sys.argv[2] names (comma-separated) in the checkout at sys.argv[1]
RUN = """
import dataclasses, hashlib, json, sys
from pathlib import Path
root = Path(sys.argv[1]).resolve()
paths = sys.argv[2].split(",")
sys.path[:0] = [str(root), str(root / "src")]
import numpy as np, torch
import chip_smoke as cs
from repro_torch import stream
from repro_torch.core import ControlPlane, simulate, synthetic_matern_problem
from repro_torch.core.tenancy import _matern_block_chol, _matern_draw
from repro_torch.devplane import DevPlaneEngine, two_class_registry
from repro_torch.kernels import ei_score, gp_readout, ref
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ssd as ssd_mod
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
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
if "churn" in paths:
    plane = ControlPlane(np.random.default_rng(0), scorer="sharded", num_shards=4,
                         shard_topk=cs.TOPK, score_kernel="eirate_topk",
                         model_capacity=1024, tenant_capacity=16, device=dev)
    picks, rec = cs.churn_trace(plane, cs.CHURN_DECISIONS, 0, _matern_block_chol,
                                _matern_draw, counters, torch.cuda.synchronize)
    out["churn"] = dict(ms=rec["mean_decision_ms"], launches=rec["launches"],
                        sha=sha(picks))
if "devplane" in paths:
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
if "fig5" in paths:
    reset()
    r = simulate(synthetic_matern_problem(50, 50, seed=0), "mdmt", num_devices=4,
                 seed=0, horizon=cs.FIG5_HORIZON, device="cuda")
    torch.cuda.synchronize()
    out["fig5"] = dict(ms=r.decision_seconds / max(r.decisions, 1) * 1e3,
                       decisions=r.decisions, launches=read(), sha=sha(r.trials))
if "readout" in paths:
    gen = torch.Generator(device=dev).manual_seed(0)
    # (k, n, columns of the buffer, first column)
    for k, n, width, first in ((50, 50, 50, 0), (200, 2048, 2048, 0),
                               (512, 2500, 2500, 0), (1024, 100_000, 100_000, 0),
                               (1024, 25_000, 100_000, 25_000)):
        W = (torch.randn((k, width), generator=gen, device=dev) * 0.3)[:, first:first + n]
        alpha = torch.randn(k, generator=gen, device=dev)
        mu0 = torch.randn(n, generator=gen, device=dev)
        kd = (W * W).sum(0) + 1.0
        got = gp_readout.gp_readout(W, alpha, mu0, kd)
        want = ref.gp_readout_ref(W, alpha, mu0, kd)
        cs.check(all(torch.equal(g, w) for g, w in zip(got, want)),
                 f"readout {k} {n} differs from the plain version")
        name = f"readout_k{k}_n{n}" + ("" if width == n else f"_of{width}")
        out[name] = dict(ms=cs.device_ms(lambda: gp_readout.gp_readout(W, alpha, mu0, kd),
                                         "gp_readout_kernel", 200 if k * n <= 10**6 else 20),
                         sha=sha([t.cpu().numpy().tobytes() for t in got]))
if "flash" in paths:
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((2, 2048, h, 128), generator=gen, device=dev)
               for h in (32, 8, 8))
    cs.held("flash float32", flash_mod.flash_attention(q, k, v), ref.attention_ref(q, k, v))
    out["flash_f32"] = dict(ms=cs.device_ms(lambda: flash_mod.flash_attention(q, k, v),
                                            "flash", 10))
    out["flash_f32_call"] = dict(ms=cs.cuda_ms(lambda: flash_mod.flash_attention(q, k, v),
                                               10))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out["sdpa_f32"] = dict(ms=cs.cuda_ms(
        lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), 10))
    q, k, v = (t[:1, :513] for t in (q, k, v))
    out["flash_f32_s513"] = dict(ms=cs.device_ms(lambda: flash_mod.flash_attention(q, k, v),
                                                 "flash", 20))
if "ssd" in paths:
    gen = torch.Generator(device=dev).manual_seed(0)
    def ssd_inputs(B, S, H, P, N):
        x = torch.randn((B, S, H, P), generator=gen, device=dev)
        dt = torch.rand((B, S, H), generator=gen, device=dev) * 0.099 + 0.001
        la = -dt * (torch.rand((H,), generator=gen, device=dev) * 1.5 + 0.5)
        b, c = (torch.randn((B, S, N), generator=gen, device=dev) for _ in range(2))
        return x, dt, la, b, c
    def kernels(S, chunk):
        # this checkout's float32 kernels: a route's list, or the one
        # CUDA-core kernel of a checkout that has no tf32x3 route
        if "tf32x3" in getattr(ssd_mod, "ROUTE_KERNELS", {}):
            return ssd_mod.call_kernels("tf32x3", S, chunk)
        return ("ssd_kernel",)
    args = ssd_inputs(2, 2048, 64, 64, 128)
    call = lambda: ssd_mod.ssd_mix(*args, chunk=256)
    cs.held("ssd float32", call(), ref.ssd_ref(*args))
    out["ssd_f32"] = dict(ms=cs.device_ms(call, kernels(2048, 256), 10))
    out["ssd_f32_call"] = dict(ms=cs.cuda_ms(call, 10))
    args = ssd_inputs(1, 513, 64, 64, 128)
    out["ssd_f32_s513"] = dict(ms=cs.device_ms(lambda: ssd_mod.ssd_mix(*args, chunk=513),
                                               kernels(513, 513), 20))
print(json.dumps(out))
"""


def run(checkout: Path, paths: list[str]) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN, str(checkout), ",".join(paths)],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"the runs in {checkout} failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--paths", default=",".join(PATHS))
    args = ap.parse_args()
    paths = args.paths.split(",")
    unknown = set(paths) - set(PATHS)
    if unknown:
        ap.error(f"unknown paths {sorted(unknown)}; choose from {PATHS}")
    sides = {"parent": args.parent.resolve(), "change": ROOT}
    runs: dict[str, list[dict]] = {"parent": [], "change": []}
    for side in sides:
        print(json.dumps(dict(side=side, warmup=True, **run(sides[side], paths))),
              flush=True)
    for _ in range(args.rounds):
        for side in ("parent", "change", "change", "parent"):
            rec = run(sides[side], paths)
            runs[side].append(rec)
            print(json.dumps(dict(side=side, **rec)), flush=True)
    summary = {}
    for metric, first in runs["parent"][0].items():
        ms = {side: [r[metric]["ms"] for r in rs] for side, rs in runs.items()}
        q = statistics.quantiles(ms["parent"], n=4)
        med = {side: statistics.median(v) for side, v in ms.items()}
        summary[metric] = dict(
            median_ms=med, change_minus_parent_ms=med["change"] - med["parent"],
            change_over_parent=med["change"] / med["parent"],
            parent_quartile_spread_ms=q[2] - q[0],
            change_wins=sum(c < p for p, c in zip(ms["parent"], ms["change"])),
            pairs=len(ms["parent"]))
        if "sha" in first:
            summary[metric]["results_equal"] = len(
                {r[metric]["sha"] for rs in runs.values() for r in rs}) == 1
    print(json.dumps(summary), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0 if all(m.get("results_equal", True) for m in summary.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
