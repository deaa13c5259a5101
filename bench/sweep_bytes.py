"""The least bytes a sweep call's step loop must move, counted from the
problem's shapes and the call's own logs: the yardstick of
``roofline_share``.  Each input byte is read once and each output byte
written once.

* a fold (an episode that observes a model at a step): the tenant block's
  running sums P read and written (2 m^2 float32), its prior row of K and
  its prior means (m float32 each), its posterior mean, variance and EI
  written (3 m float32);
* an EIrate decision (``mdmt``): every model's EI (n float32) and launched
  flag (n bytes) read;
* a per-tenant decision (``round_robin``, ``random``): the launched flags
  (n bytes) and the chosen tenant's EI (m float32) read;
* once a step: the cost vector (n float32).
"""

from __future__ import annotations

import numpy as np

F32 = 4


def call_bytes(num_tenants: int, models_per_tenant: int, steps: int,
               obs_model: np.ndarray, trial_user: np.ndarray) -> int:
    """Bytes of one call: ``obs_model`` (B, T) its step logs (-1 where a
    step observed nothing), ``trial_user`` (B, n) its launch hints (-2 warm
    start, -1 an EIrate pick, a tenant for a per-tenant pick)."""
    m = models_per_tenant
    n = num_tenants * m
    folds = int((np.asarray(obs_model) >= 0).sum())
    hints = np.asarray(trial_user)
    eirate = int((hints == -1).sum())
    per_tenant = int((hints >= 0).sum())
    return (folds * (2 * m * m + 2 * m + 3 * m) * F32
            + eirate * (n * F32 + n)
            + per_tenant * (n + m * F32)
            + steps * n * F32)
