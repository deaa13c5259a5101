"""End-to-end multi-tenant AutoML service with REAL training trials.

Counterpart of the reference's ``examples/multi_tenant_service.py``, with
its settings.  Every "model" is (tenant dataset x architecture from the
assigned pool); a trial genuinely trains the reduced config on the tenant's
synthetic dataset, on ``--device`` (default: the card).  The service:

  1. estimates the GP prior from two held-out tenants (the paper's protocol),
  2. schedules trials with MM-GP-EI over a fleet of two heterogeneous mesh
     slices, with c(x) from the roofline cost model,
  3. checkpoints its control state after every event,
  4. simulates a coordinator crash and resumes, re-queueing in-flight trials.

  PYTHONPATH=src python -m repro_torch.examples.multi_tenant_service [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

from repro_torch.core.fleet import Fleet
from repro_torch.core.service import (
    AutoMLService,
    RealExecutor,
    ServiceConfig,
    TenantSpec,
    estimate_prior,
)

ARCHS = ["olmo-1b", "qwen3-4b", "mamba2-1.3b", "h2o-danube-3-4b"]
SVC = ServiceConfig(steps_per_trial=10, eval_steps=2, seq_len=64, batch=4)
PRIOR_TENANTS = [TenantSpec(100, 100, 1.1), TenantSpec(101, 101, 1.7)]
TENANTS = [TenantSpec(i, i, 1.0 + 0.25 * i) for i in range(3)]
CRASH_AFTER = 5


def fleet() -> Fleet:
    return Fleet.partition_pod(total_chips=256, num_slices=2, speeds=[1.0, 0.6])


def run(executor, device=None):
    """The protocol: the prior from PRIOR_TENANTS, CRASH_AFTER trials, a
    crash, a fresh coordinator restored from the checkpoint (in a temporary
    directory), the run to its end.  Returns ((mu, K), the first service,
    the restored one)."""
    prior = estimate_prior(ARCHS, PRIOR_TENANTS, executor)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "automl_svc.json")
        service = AutoMLService(TENANTS, ARCHS, fleet(), executor, SVC, prior=prior,
                                checkpoint_path=ckpt, device=device)
        service.run(max_trials=CRASH_AFTER)
        restored = AutoMLService(TENANTS, ARCHS, fleet(), executor, SVC, prior=prior,
                                 checkpoint_path=ckpt, device=device)
        if not restored.restore():
            raise RuntimeError(f"no checkpoint at {ckpt} to restore from")
        restored.run()
    return prior, service, restored


def main(argv=None) -> AutoMLService:
    """Runs the example on real trials; returns the restored service."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    (mu, _), service, restored = run(RealExecutor(SVC, device=args.device), args.device)

    print(f"== GP prior from {len(PRIOR_TENANTS)} held-out tenants "
          f"({len(PRIOR_TENANTS) * len(ARCHS)} trial trainings) ==")
    print("prior mean per arch:", dict(zip(ARCHS, mu.round(4))))
    print(f"\n== phase 1: {CRASH_AFTER} trials, then 'crash' ==")
    for t in service.trials:
        print(f"  t={t.t_start:7.1f} -> {t.t_end:7.1f}  slice {t.slice_id} "
              f"(speed {service.fleet.slices[t.slice_id].speed})  tenant {t.tenant}  "
              f"{t.arch:16s} z={t.z:.4f}")
    print("\n== phase 2: a fresh coordinator restored from the checkpoint ==")
    print(f"restored {len(service.gp.observed)} observations; ran "
          f"{len(restored.trials)} more trials")

    print("\n== final result per tenant ==")
    A = len(ARCHS)
    for i, tenant in enumerate(TENANTS):
        zbest, abest = max(
            (restored.gp._z.get(i * A + j, -1), ARCHS[j]) for j in range(A))
        print(f"  tenant {tenant.tenant_id} (zipf {tenant.zipf_a:.2f}): "
              f"best arch = {abest} (z = {zbest:.4f})")
    return restored


if __name__ == "__main__":
    main()
