"""Paper Fig. 2: single-device comparison of MDMT vs Round-Robin vs Random
on the Azure (17x8) and DeepLearning (22x8) workloads.

Figure of merit (paper Section 6.2): time to reach a given instantaneous
regret.  The paper reports MDMT reaching the same regret "up to 5x" faster
than round robin on Azure and no significant speedup on DeepLearning; we
report the geometric-mean and max per-seed speedups at two thresholds, plus
cumulative regret.  The JAX driver's rows, on ``repro_torch.core``."""

from __future__ import annotations

import numpy as np

from ..core import (
    POLICIES,
    azure_problem,
    deeplearning_problem,
    final_regret,
    regret_curves,
)
from .common import FAST, emit, episode, parse_engine_args, require_event_engine

THRESHOLDS = {"azure": (0.03, 0.015), "deeplearning": (0.02, 0.01)}


def _gmean(xs):
    xs = np.asarray(xs, dtype=float)
    xs = xs[np.isfinite(xs) & (xs > 0)]
    return float(np.exp(np.mean(np.log(xs)))) if xs.size else float("nan")


def run(num_devices: int = 1, tag: str = "fig2", engine: str = "event",
        num_seeds: int | None = None, device=None) -> None:
    """The figure's rows; ``device=None`` runs every episode on the card."""
    require_event_engine(engine)
    seeds = range(num_seeds if num_seeds is not None else (3 if FAST else 8))
    for ds_name, maker in (("azure", azure_problem),
                           ("deeplearning", deeplearning_problem)):
        ths = THRESHOLDS[ds_name]
        t_hit = {p: {th: [] for th in ths} for p in POLICIES}
        regret = {p: [] for p in POLICIES}
        dec_us = {p: [] for p in POLICIES}
        for seed in seeds:
            prob = maker(seed=seed)
            for pol in POLICIES:
                res = episode(prob, pol, num_devices, seed, device)
                c = regret_curves(res)
                for th in ths:
                    t_hit[pol][th].append(c.time_to_instantaneous(th))
                regret[pol].append(final_regret(res))
                dec_us[pol].append(
                    res.decision_seconds / max(res.decisions, 1) * 1e6)
        for pol in POLICIES:
            derived = {"cum_regret": f"{np.mean(regret[pol]):.0f}"}
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
            emit(f"{tag}_{ds_name}_{pol}", float(np.mean(dec_us[pol])), **derived)


def main(device=None) -> None:
    args = parse_engine_args()
    run(num_devices=1, tag="fig2", engine=args.engine, num_seeds=args.seeds,
        device=device)


if __name__ == "__main__":
    main()
