"""The batched sweep: B episodes of the paper's Algorithm 1 in one call of
the port's ``repro_torch.core.sim_batched.simulate_batch``, called back to
back over the measured window.

A cell is a deployment (``configs/<name>.json``: its generator and sizes)
under a traffic mix (``traffic/<name>.json``: policies, device counts,
ground-truth draws per (policy, M) pair, episodes checked a run), read by
the one traffic generator below.  Set-up builds the problem, draws the
ground truths on the device from the seed, lays out the episodes and makes
one warm call at the cell's own B (T is static, so no shorter call warms
the same work); a traced run counts that call's aten operations.  The
window runs whole calls while its elapsed time is under ``seconds`` and
ends at a call boundary; it keeps the checked episodes' rows of every
call.  A traced run then profiles further calls until two traces agree
(``devtrace.profile_agreed``).  The reference runs last, over a pool of
processes, once the window has closed.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

from bench import check, devtrace, load_module, reference, sweep_bytes

REFERENCE_WORKERS = 4


def generator(root: Path, cfg: dict):
    """The configuration's generator, ``bench/generators/<name>.py``."""
    return load_module(root / "bench" / "generators" / f"{cfg['generator']}.py",
                       f"bench_generator_{cfg['generator']}")


def episodes(traffic: dict, seed: int) -> list[tuple[str, int, int, int]]:
    """The traffic generator: (policy, devices, ground-truth draw, episode
    seed) for every episode, policy-major, then device count, then draw.
    Every (policy, M) pair runs the same draws, so curves over M and
    policies are paired; the seeds (the ``random`` policy's key chains)
    differ per episode."""
    layout = [(p, M, k) for p in traffic["policies"] for M in traffic["device_counts"]
              for k in range(traffic["draws"])]
    seeds = np.random.default_rng([seed, 1]).integers(0, 2**32, size=len(layout))
    return [(p, M, k, int(s)) for (p, M, k), s in zip(layout, seeds)]


def checked_episodes(batch: int, count: int, seed: int) -> list[int]:
    """One episode drawn from the seed in each of ``count`` equal stretches
    of the batch, so every policy and device-count range is checked."""
    rng = np.random.default_rng([seed, 2])
    return [int(b[rng.integers(len(b))]) for b in np.array_split(np.arange(batch), count)]


def reference_jobs(cfg: dict, layout: list, truth, picked: list[int], steps: int) -> list[tuple]:
    """``reference.run_episode``'s arguments after the problem, for each
    picked episode."""
    return [(layout[i][0], layout[i][1], layout[i][3], truth[layout[i][2]],
             cfg["warm_start"], cfg["jitter"], steps) for i in picked]


def run(root: Path, cell: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, simulate, t_start: float) -> dict:
    """One run of a sweep cell: the readings the metric readers take.
    ``simulate`` is the program's entry (by default ``simulate_batch``)."""
    from repro_torch.core.sim_batched import EpisodeSpec
    from repro_torch.core.tenancy import Problem

    def phase(name: str, since: float) -> float:
        now = time.perf_counter()
        print(f"phase {name} {now - since:.3f} s", file=sys.stderr, flush=True)
        return now

    if simulate is None:
        from repro_torch.core.sim_batched import simulate_batch as simulate
    cfg, traffic = cell["config"], cell["traffic"]
    gen = generator(root, cfg)
    mark = phase("imports", t_start)
    inputs = gen.build(cfg, seed)
    truth = gen.draw_truth(cfg, inputs, traffic["draws"], seed, device)
    mark = phase("inputs", mark)
    layout = episodes(traffic, seed)
    specs = [EpisodeSpec(p, M, seed=s, z_true=truth[k]) for p, M, k, s in layout]
    problem = Problem(K=inputs["K"], mu0=inputs["mu0"], z_true=inputs["z_true"],
                      cost=inputs["cost"], membership=inputs["membership"])
    N, n = problem.membership.shape
    B, T = len(specs), n + max(traffic["device_counts"])
    picked = checked_episodes(B, traffic["check_episodes"], seed)

    def call():
        return simulate(problem, specs, cfg["warm_start"], cfg["jitter"], device=device)

    # the warm call (its copies back wait for the card); in a traced run the
    # dispatch mode counts its operations, a count the same in every call
    ops = None
    if trace:
        ops = devtrace.count_ops(call, device.type)[1]
    else:
        call()
    mark = phase("warm_call", mark)
    setup_s = time.perf_counter() - t_start

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    calls, kept = [], []
    t0 = time.perf_counter()
    while True:
        c0 = time.perf_counter()
        result = call()
        c1 = time.perf_counter()
        calls.append({"host_s": c1 - c0, "wall_s": float(result.wall_seconds)})
        print(f"call {len(calls)} {c1 - c0:.3f} s, loop and copies {result.wall_seconds:.3f} s",
              file=sys.stderr, flush=True)
        kept.append({i: check.episode_rows(result, i) for i in picked})
        del result
        if c1 - t0 >= seconds:
            break
    window = {"episodes": B * len(calls), "elapsed_s": c1 - t0, "calls": calls,
              "peak_bytes": torch.cuda.max_memory_allocated() if device.type == "cuda" else None}

    prof = moved = None
    mark = time.perf_counter()
    if trace and device.type == "cuda":
        result, prof, seen = devtrace.profile_agreed(call)
        moved = sweep_bytes.call_bytes(N, n // N, T, result.obs_model, result.trial_user)
        del result
        mark = phase("profiled_calls", mark)
        print(f"trace {prof['kernels']} kernel records, {prof['launches']} launches; "
              f"device records of the traced calls {seen}", file=sys.stderr, flush=True)

    jobs = reference_jobs(cfg, layout, truth, picked, T)
    refs = reference.run_many(inputs, jobs, min(REFERENCE_WORKERS, len(jobs)))
    readings = [check.compare(kept[j % len(kept)][i], ref)
                for j, (i, ref) in enumerate(zip(picked, refs))]
    phase("reference", mark)
    failed = sum(any(r[k] > cell["checks"][k] for k in check.NAMES) for r in readings)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"setup_s": setup_s, "window": window, "steps": T, "batch": B, "device_kind": kind,
            "ops": ops, "profile": prof, "bytes": moved,
            "checks": check.worst(readings),
            "checked": {"name": "episodes_checked", "value": len(readings),
                        "limit": traffic["check_episodes"]},
            "attempted": window["episodes"], "failed": failed}
