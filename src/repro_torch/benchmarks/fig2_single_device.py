"""Paper Fig. 2: single-device comparison of MDMT vs Round-Robin vs Random
on the Azure (17x8) and DeepLearning (22x8) workloads.

Figure of merit (paper Section 6.2): time to reach a given instantaneous
regret.  The paper reports MDMT reaching the same regret "up to 5x" faster
than round robin on Azure and no significant speedup on DeepLearning; we
report the geometric-mean and max per-seed speedups at two thresholds, plus
cumulative regret.  The JAX driver's rows, on ``repro_torch.core``.

``--engine batched`` runs each seed's three policies as one
``repro_torch.core.simulate_batch`` call (identical trial sequences for the
deterministic policies; the random baseline differs per seed only in its
random stream, see DESIGN.md §6)."""

from __future__ import annotations

import numpy as np

from ..core import (
    POLICIES,
    EpisodeSpec,
    azure_problem,
    deeplearning_problem,
    final_regret,
    regret_curves,
    simulate_batch,
)
from .common import FAST, emit, episode, parse_engine_args

THRESHOLDS = {"azure": (0.03, 0.015), "deeplearning": (0.02, 0.01)}


def _gmean(xs):
    xs = np.asarray(xs, dtype=float)
    xs = xs[np.isfinite(xs) & (xs > 0)]
    return float(np.exp(np.mean(np.log(xs)))) if xs.size else float("nan")


def run(num_devices: int = 1, tag: str = "fig2", engine: str = "event",
        num_seeds: int | None = None, device=None) -> None:
    """The figure's rows; ``device=None`` runs every episode on the card."""
    seeds = range(num_seeds if num_seeds is not None else (3 if FAST else 8))
    for ds_name, maker in (("azure", azure_problem),
                           ("deeplearning", deeplearning_problem)):
        ths = THRESHOLDS[ds_name]
        t_hit = {p: {th: [] for th in ths} for p in POLICIES}
        regret = {p: [] for p in POLICIES}
        dec_us = {p: [] for p in POLICIES}
        for seed in seeds:
            prob = maker(seed=seed)
            if engine == "batched":
                # One call per (problem, seed): the ease.ml generators
                # resample the *prior* (K, mu0, cost) per seed, so seeds
                # cannot share a batch through the z_true override.
                batch = simulate_batch(
                    prob, [EpisodeSpec(pol, num_devices, seed) for pol in POLICIES],
                    device=device)
                # a batch's wall clock per episode (the first call carries
                # the card's warm-up), not a decision's latency: the rows
                # carry engine=batched
                batch_us = batch.wall_seconds / len(POLICIES) * 1e6
            for i, pol in enumerate(POLICIES):
                if engine == "batched":
                    res = batch.episode_result(i)
                else:
                    res = episode(prob, pol, num_devices, seed, device)
                c = regret_curves(res)
                for th in ths:
                    t_hit[pol][th].append(c.time_to_instantaneous(th))
                regret[pol].append(final_regret(res))
                dec_us[pol].append(
                    batch_us if engine == "batched" else
                    res.decision_seconds / max(res.decisions, 1) * 1e6)
        for pol in POLICIES:
            derived = {"cum_regret": f"{np.mean(regret[pol]):.0f}"}
            if engine == "batched":
                derived["engine"] = "batched"
            for th in ths:
                derived[f"t_reach_{th}"] = f"{np.mean(t_hit[pol][th]):.0f}"
            if pol == "mdmt":
                for other in ("round_robin", "random"):
                    ratios = [
                        np.asarray(t_hit[other][th]) / np.asarray(t_hit["mdmt"][th])
                        for th in ths]
                    flat = np.concatenate(ratios)
                    derived[f"speedup_vs_{other}_gmean"] = f"{_gmean(flat):.2f}"
                    finite = flat[np.isfinite(flat)]
                    derived[f"speedup_vs_{other}_max"] = (
                        f"{finite.max():.2f}" if finite.size else "nan")
                derived["regret_vs_rr"] = (
                    f"{np.mean(regret['round_robin']) / np.mean(regret['mdmt']):.2f}")
            # batched: the minimum over seeds, the steady-state episode cost
            # (the first seed's call carries the warm-up)
            us = (float(np.min(dec_us[pol])) if engine == "batched"
                  else float(np.mean(dec_us[pol])))
            emit(f"{tag}_{ds_name}_{pol}", us, **derived)


def main(device=None) -> None:
    args = parse_engine_args()
    run(num_devices=1, tag="fig2", engine=args.engine, num_seeds=args.seeds,
        device=device)


if __name__ == "__main__":
    main()
