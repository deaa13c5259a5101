"""Paper Fig. 5: near-linear device speedup on the synthetic workload.

Protocol (Section 6.3): 50 users x 50 models, performance sampled per user
from a zero-mean Matérn nu=5/2 GP, samples shifted non-negative; measure the
average time for the instantaneous regret to hit 0.01, repeating per device
count; the paper observes near-linear speedup.  The JAX driver's rows, on
``repro_torch.core``.

Engines (``--engine``):
  event    one host event-loop episode per (device count, repeat): exact,
           slow.
  batched  the whole (device count x seed) grid as ONE
           ``repro_torch.core.simulate_batch`` call, with a fresh GP sample
           per seed.  ``--seeds S`` sets the seeds (default 16, 4 under
           BENCH_FAST); more seeds cost little more wall, since a step's
           launches serve every episode of the batch.
"""

from __future__ import annotations

import numpy as np

from ..core import (
    EpisodeSpec,
    regret_curves,
    simulate_batch,
    synthetic_matern_problem,
    synthetic_matern_z,
)
from .common import FAST, emit, episode, parse_engine_args

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


def run_batched(seeds: int, device=None) -> None:
    """The whole grid in one call on ``device`` (None: the card): the prior
    shared, z resampled per seed through the per-episode ``z_true``
    override."""
    prob = synthetic_matern_problem(num_users=50, num_models_per_user=50, seed=0)
    z_per_seed = [
        synthetic_matern_z(num_users=50, num_models_per_user=50, seed=s)
        for s in range(seeds)]
    specs = [EpisodeSpec("mdmt", M, seed=s, z_true=z_per_seed[s])
             for M in DEVICES for s in range(seeds)]
    batch = simulate_batch(prob, specs, device=device)
    tt = batch.time_to_instantaneous(CUTOFF).reshape(len(DEVICES), seeds)
    us_per_episode = batch.wall_seconds / len(specs) * 1e6
    base = None
    for Mi, M in enumerate(DEVICES):
        t = float(np.mean(tt[Mi]))
        if base is None:
            base = t
        emit(f"fig5_synthetic_batched_M{M}", us_per_episode,
             t_reach_0p01=f"{t:.0f}",
             speedup_vs_M1=f"{base / t:.2f}",
             ideal=f"{M}",
             linearity=f"{base / t / M:.2f}")
    emit("fig5_batched_wall", us_per_episode,
         episodes=f"{len(specs)}",
         wall_s=f"{batch.wall_seconds:.1f}")


def main(device=None) -> None:
    args = parse_engine_args()
    if args.engine == "batched":
        seeds = args.seeds if args.seeds is not None else (4 if FAST else 16)
        run_batched(seeds=seeds, device=device)
    else:
        run_event(seeds=args.seeds if args.seeds is not None else REPEATS,
                  device=device)


if __name__ == "__main__":
    main()
