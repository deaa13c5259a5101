"""Paper Fig. 5: near-linear device speedup on the synthetic workload.

Protocol (Section 6.3): 50 users x 50 models, performance sampled per user
from a zero-mean Matérn nu=5/2 GP, samples shifted non-negative; measure the
average time for the instantaneous regret to hit 0.01, repeating per device
count; the paper observes near-linear speedup.  One host event-loop episode
per (device count, repeat), the JAX driver's ``--engine event`` rows."""

from __future__ import annotations

import numpy as np

from ..core import regret_curves, synthetic_matern_problem
from .common import FAST, emit, episode, parse_engine_args, require_event_engine

DEVICES = (1, 2, 4, 8, 16) if not FAST else (1, 4, 16)
REPEATS = 2 if FAST else 5
CUTOFF = 0.01


def run_event(seeds: int, device=None) -> None:
    """The figure's rows; ``device=None`` runs every episode on the card."""
    base = None
    for M in DEVICES:
        ts, dec = [], []
        for rep in range(seeds):
            prob = synthetic_matern_problem(num_users=50, num_models_per_user=50,
                                            seed=rep)
            res = episode(prob, "mdmt", M, rep, device)
            ts.append(regret_curves(res).time_to_instantaneous(CUTOFF))
            dec.append(res.decision_seconds / max(res.decisions, 1) * 1e6)
        t = float(np.mean(ts))
        if base is None:
            base = t
        emit(f"fig5_synthetic_M{M}", float(np.mean(dec)),
             t_reach_0p01=f"{t:.0f}",
             speedup_vs_M1=f"{base / t:.2f}",
             ideal=f"{M}",
             linearity=f"{base / t / M:.2f}")


def main(device=None) -> None:
    args = parse_engine_args()
    require_event_engine(args.engine)
    run_event(seeds=args.seeds if args.seeds is not None else REPEATS,
              device=device)


if __name__ == "__main__":
    main()
