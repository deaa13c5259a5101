"""Quickstart: the paper's MM-GP-EI scheduler in one page.

Counterpart of the reference's ``examples/quickstart.py``, with its
settings and its lines: a synthetic Matérn-5/2 workload (20 tenants x 30
models), the three policies of Section 6 on 4 shared devices, and the
global-happiness metrics.  The episodes run on ``--device`` (default: the
card, which must be present; ``--device cpu`` runs the plain versions).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.core import (
    POLICIES,
    final_regret,
    regret_curves,
    simulate,
    synthetic_matern_problem,
)


def main(device=None) -> None:
    """Prints the reference example's lines, the episodes on ``device``."""
    problem = synthetic_matern_problem(num_users=20, num_models_per_user=30, seed=0)
    print(f"workload: {problem.name}  ({problem.num_users} tenants, "
          f"{problem.num_models} models, 4 devices)\n")

    results = {}
    for policy in POLICIES:
        res = simulate(problem, policy, num_devices=4, seed=0, device=device)
        curves = regret_curves(res)
        results[policy] = (final_regret(res), curves.time_to_instantaneous(0.01))
        print(f"{policy:12s}  cumulative regret = {results[policy][0]:8.1f}   "
              f"time to inst. regret 0.01 = {results[policy][1]:6.1f}")

    rr, mdmt = results["round_robin"][1], results["mdmt"][1]
    print(f"\nMM-GP-EI reaches regret 0.01 {rr / mdmt:.2f}x faster than "
          f"round robin (paper Fig. 2/5 qualitative claim).")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the episodes (default: the card)")
    main(device=ap.parse_args().device)
