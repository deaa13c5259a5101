"""Paper Fig. 3: impact of multiple devices on MM-GP-EI.

Figure of merit: time for the instantaneous regret to reach the threshold as
the device count grows (the paper shows the curves dropping faster with more
devices, with larger gains on DeepLearning: 14 test users vs Azure's 9).
The JAX driver's rows, on ``repro_torch.core``.

``--engine batched`` runs each seed's whole device sweep as one
``repro_torch.core.simulate_batch`` call (see DESIGN.md §6)."""

from __future__ import annotations

import numpy as np

from ..core import (
    EpisodeSpec,
    azure_problem,
    deeplearning_problem,
    regret_curves,
    simulate_batch,
)
from .common import FAST, emit, episode, parse_engine_args

DEVICES = (1, 2, 4, 8)
THRESHOLDS = {"azure": 0.03, "deeplearning": 0.02}


def main(device=None) -> None:
    """The figure's rows; ``device=None`` runs every episode on the card."""
    args = parse_engine_args()
    engine = args.engine
    seeds = range(args.seeds if args.seeds is not None else (2 if FAST else 5))
    for ds_name, maker in (("azure", azure_problem),
                           ("deeplearning", deeplearning_problem)):
        th = THRESHOLDS[ds_name]
        ts = {M: [] for M in DEVICES}
        dec = {M: [] for M in DEVICES}
        for seed in seeds:
            prob = maker(seed=seed)
            if engine == "batched":
                batch = simulate_batch(
                    prob, [EpisodeSpec("mdmt", M, seed) for M in DEVICES],
                    device=device)
                tt = batch.time_to_instantaneous(th)
                # a batch's wall clock per episode, not a decision's latency:
                # the rows carry engine=batched
                us = batch.wall_seconds / len(DEVICES) * 1e6
                for Mi, M in enumerate(DEVICES):
                    ts[M].append(float(tt[Mi]))
                    dec[M].append(us)
            else:
                for M in DEVICES:
                    res = episode(prob, "mdmt", M, seed, device)
                    ts[M].append(regret_curves(res).time_to_instantaneous(th))
                    dec[M].append(res.decision_seconds / max(res.decisions, 1) * 1e6)
        base = None
        for M in DEVICES:
            t = float(np.mean(ts[M]))
            if base is None:
                base = t
            derived = {f"t_reach_{th}": f"{t:.0f}",
                       "speedup_vs_M1": f"{base / t:.2f}",
                       "ideal": f"{M}"}
            if engine == "batched":
                derived["engine"] = "batched"
            # batched: the minimum over seeds, the steady-state episode cost
            # (the first seed's call carries the warm-up)
            us = (float(np.min(dec[M])) if engine == "batched"
                  else float(np.mean(dec[M])))
            emit(f"fig3_{ds_name}_M{M}", us, **derived)


if __name__ == "__main__":
    main()
