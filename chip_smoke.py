#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main path on one GPU and checks it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and
``nvcc``.  Phases, each printed as one JSON line; any failure exits non-zero:

  build          compile every kernel of ``src/repro_torch/kernels/csrc/`` for
                 sm_90a into ``build/repro_torch/`` (one nvcc per source, in
                 parallel; a library already built from the same source is reused)
  kernels        each kernel against its plain PyTorch version on the card,
                 at the paper's size and at service size, with CUDA-event times
                 and the least time the card could take for the same work
  episode_fig5   Algorithm 1 (mdmt, M = 4) on the Fig-5 problem, 50 tenants x
                 50 models, on the card and on the CPU: equal trial sequences,
                 and every decision launched the EIrate kernel once
  episode_dense  the same on a 1 x 2,048 prior, which takes the dense GP engine
  baselines      round_robin and random on the Azure workload, card vs CPU

Then a line listing each kernel, the card's name and power limit as
``nvidia-smi`` reports them, and as the last line
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
# arithmetic steps of one member pair's EI (sub, div, scale, abs, erf or
# erfc, add, halve, square, add, halve, exp, mul, add, mul, accumulate),
# each erf/erfc/exp counted as one operation: a floor, not a cost model
EI_OPS = 15

FIG5_HORIZON = 600.0           # before the pool runs dry: every decision scores
DENSE_HORIZON = 50.0           # about 200 decisions at M = 4, unit costs


def emit(obj) -> None:
    print(json.dumps(obj, allow_nan=False), flush=True)


def finite(x: float) -> float | None:
    """JSON has no infinity: a horizon of inf, or a regret level never
    reached, prints as null."""
    return float(x) if np.isfinite(x) else None


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call on the stream, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---- kernels ------------------------------------------------------------------

def eirate_case(name, N, n, layout, rng, dev, ei_score, ref):
    mu = rng.standard_normal(n).astype(np.float32)
    sg = np.abs(rng.standard_normal(n)).astype(np.float32)
    sg[rng.random(n) < 0.125] = 0.0                     # sigma = 0 entries
    best = rng.normal(0.5, 0.5, N).astype(np.float32)
    cost = rng.uniform(0.3, 3.0, n).astype(np.float32)
    sel = rng.random(n) < 0.25                          # selected entries
    if layout == "disjoint":            # the paper's workloads: one owner each
        mem = np.zeros((N, n), bool)
        mem[np.arange(n) * N // n, np.arange(n)] = True
    elif layout == "dense":
        mem = rng.random((N, n)) < 0.4
    else:                               # all-equal tie case
        mu[:], sg[:], best[:], cost[:], sel[:] = 0.0, 1.0, 0.0, 1.0, False
        mem = np.ones((N, n), bool)
    args = [torch.from_numpy(a).to(dev) for a in (mu, sg, best, mem, cost, sel)]
    got = ei_score.eirate(*args)
    want = ref.eirate_ref(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err == 0.0, f"eirate {name}: kernel and plain version differ by {err}")
    if layout == "tie":
        check(bool((got == got[0]).all()) and int(torch.argmax(got)) == 0,
              "eirate tie case: equal inputs must give bit-equal scores")
    iters = 200 if n * N <= 10**6 else 20
    ms = cuda_ms(lambda: ei_score.eirate(*args), iters)
    plain_ms = cuda_ms(lambda: ref.eirate_ref(*args), max(iters // 10, 3))
    pairs = mem.sum()
    pairs_pos = mem[:, sg > 0].sum()
    nbytes = N * n + n * (4 * 4 + 1) + N * 4
    ops = pairs_pos * EI_OPS + (pairs - pairs_pos) * 2 + n * 2
    b_ms, b_by = bound_ms(nbytes, ops)
    return dict(case=name, N=N, n=n, membership=layout, member_pairs=int(pairs),
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def readout_case(k, n, emit_sd, rng, dev, gp_readout, ref):
    W = torch.from_numpy((rng.standard_normal((k, n)) * 0.3).astype(np.float32)).to(dev)
    alpha = torch.from_numpy(rng.standard_normal(k).astype(np.float32)).to(dev)
    mu0 = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    kd = (W * W).sum(0) + torch.rand(n, device=dev)
    got = gp_readout.gp_readout(W, alpha, mu0, kd, emit_sd=emit_sd)
    want = ref.gp_readout_ref(W, alpha, mu0, kd, emit_sd=emit_sd)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(err == 0.0, f"gp_readout ({k}, {n}): kernel and plain version "
                      f"differ by {err}")
    if k == 0:
        check(torch.equal(got[0], mu0), "gp_readout k = 0 must give mu = mu0")
    iters = 200 if k * n <= 10**6 else 20
    ms = cuda_ms(lambda: gp_readout.gp_readout(W, alpha, mu0, kd, emit_sd=emit_sd), iters)
    plain_ms = cuda_ms(lambda: ref.gp_readout_ref(W, alpha, mu0, kd, emit_sd=emit_sd),
                       max(iters // 10, 3))
    nbytes = 4 * (k * n + k + 4 * n)
    b_ms, b_by = bound_ms(nbytes, 4 * k * n + 3 * n)
    return dict(case=f"k{k}_n{n}" + ("_sd" if emit_sd else ""), k=k, n=n,
                emit_sd=emit_sd, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by)


# ---- episodes -----------------------------------------------------------------

def episode(name, problem, policy, M, horizon, counters, simulate, regret_curves):
    """One episode on the card with the launch counts of exactly that run,
    then the same episode on the CPU (plain versions); trial sequences must
    be equal."""
    for mod in counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    gpu = simulate(problem, policy, num_devices=M, seed=0, horizon=horizon,
                   device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: mod.launches for k, mod in counters.items()}
    t0 = time.perf_counter()
    cpu = simulate(problem, policy, num_devices=M, seed=0, horizon=horizon,
                   device="cpu")
    cpu_wall = time.perf_counter() - t0
    check(gpu.trials == cpu.trials,
          f"{name}: the card's trial sequence differs from the CPU's")
    check(all(0 <= t.model < problem.num_models for t in gpu.trials)
          and all(t.z is None or np.isfinite(t.z) for t in gpu.trials),
          f"{name}: malformed trial log")
    curves = regret_curves(gpu)
    check(bool(np.isfinite(curves.cumulative).all()), f"{name}: non-finite regret")
    return gpu, dict(
        phase=name, problem=problem.name, policy=policy, num_devices=M,
        horizon=finite(horizon), trials=len(gpu.trials), decisions=gpu.decisions,
        mean_decision_ms=gpu.decision_seconds / max(gpu.decisions, 1) * 1e3,
        cpu_mean_decision_ms=cpu.decision_seconds / max(cpu.decisions, 1) * 1e3,
        time_to_regret_0_01=finite(curves.time_to_instantaneous(0.01)),
        wall_s=wall, cpu_wall_s=cpu_wall, launches=launches,
        trials_equal_cpu=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch import _build
    from repro_torch.core import (azure_problem, regret_curves, simulate,
                                  synthetic_matern_problem)
    from repro_torch.kernels import ei_score, gp_readout, ref

    dev = torch.device("cuda")

    t0 = time.perf_counter()
    per_source = _build.build()
    regs = {name: [ln.strip() for ln in log.splitlines() if "registers" in ln]
            for name, log in _build.BUILD_LOG.items()}
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              per_source=per_source, ptxas=regs,
              libraries=[str(_build.library_path(s).relative_to(ROOT))
                         for s in _build.sources()]))

    rng = np.random.default_rng(0)
    ei_cases = [eirate_case(*c, rng, dev, ei_score, ref) for c in (
        ("paper_disjoint", 50, 2500, "disjoint"),
        ("paper_dense", 50, 2500, "dense"),
        ("paper_tie", 50, 2500, "tie"),
        ("service_disjoint", 1000, 100_000, "disjoint"),
        ("service_dense", 1000, 100_000, "dense"))]
    ro_cases = [readout_case(k, n, sd, rng, dev, gp_readout, ref)
                for k, n in ((0, 50), (50, 50), (512, 2500), (1024, 100_000))
                for sd in (False, True)]
    emit(dict(phase="kernels", tolerance=0.0,
              tolerance_reason="each kernel does its plain version's arithmetic "
              "step for step: no multiply-add contraction (-fmad=false), sums in "
              "ascending order, erf/erfc/exp in double rounded once, IEEE sqrt; "
              "so both are held bit-equal",
              eirate=ei_cases, gp_readout=ro_cases))

    counters = {"eirate": ei_score, "gp_readout": gp_readout}
    fig5 = synthetic_matern_problem(50, 50, seed=0)
    res, rec = episode("episode_fig5", fig5, "mdmt", 4, FIG5_HORIZON, counters,
                       simulate, regret_curves)
    main_launches = rec["launches"]
    policy_trials = sum(t.user_hint == -1 for t in res.trials)
    check(main_launches["eirate"] == res.decisions == policy_trials,
          f"episode_fig5: {main_launches['eirate']} EIrate launches for "
          f"{res.decisions} decisions")
    check(main_launches["gp_readout"] > 0, "episode_fig5: no readout launch")
    emit(rec)

    dense = synthetic_matern_problem(1, 2048, seed=0)
    res, rec = episode("episode_dense", dense, "mdmt", 4, DENSE_HORIZON, counters,
                       simulate, regret_curves)
    check(rec["launches"]["eirate"] == res.decisions
          and rec["launches"]["gp_readout"] >= res.decisions,
          f"episode_dense: launches {rec['launches']} for {res.decisions} decisions")
    emit(rec)

    azure = azure_problem(0)
    for policy in ("round_robin", "random"):
        _, rec = episode("baselines", azure, policy, 4, np.inf, counters,
                         simulate, regret_curves)
        check(rec["launches"]["gp_readout"] > 0, "baselines: no readout launch")
        emit(rec)

    head = {"eirate": ei_cases[0], "gp_readout": ro_cases[2]}   # Fig-5 shapes
    sources = {"eirate": ("src/repro_torch/kernels/csrc/ei_score.cu",
                          "src/repro/kernels/ei_score.py:185"),
               "gp_readout": ("src/repro_torch/kernels/csrc/gp_readout.cu",
                              "src/repro/kernels/gp_readout.py:85")}
    cases = {"eirate": ei_cases, "gp_readout": ro_cases}
    emit({"kernels": [dict(
        name=name, route="cuda", source=sources[name][0],
        replaces=sources[name][1], launches=main_launches[name],
        max_abs_err=max(c["max_abs_err"] for c in cases[name]),
        ms=head[name]["ms"], plain_ms=head[name]["plain_ms"],
        bound_ms=head[name]["bound_ms"], bound_by=head[name]["bound_by"],
        library_ms=None, shape_of_times=head[name]["case"])
        for name in ("eirate", "gp_readout")]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
