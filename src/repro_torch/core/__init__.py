"""The paper's contribution, ported: multi-device, multi-tenant GP-EI.

  gp.py            zero-noise GP posterior (masked one-shot, incremental,
                   block-diagonal engines)
  ei.py            tau / EI / multi-tenant EI / EIrate (eqs. 3-6, Lemma 1),
                   and its class axis (the elastic device plane)
  fleet.py         device slices: health, classes, join / leave / preempt
  miu.py           Maximum Incremental Uncertainty (Section 5.1)
  tenancy.py       problem instances (Azure / DeepLearning / Matérn synthetic)
  control_plane.py the per-event decision core (GP fold + EIrate pick),
                   closed and open world, scorers "ops" and "sharded"
  scheduler.py     event-driven MM-GP-EI + round-robin/random baselines
  sim_batched.py   batched synchronous-slot engine: many episodes as one
                   stream of batched tensor steps (DESIGN.md §6)
  regret.py        cumulative + instantaneous global-happiness regret
  cost_model.py    roofline trial-cost estimate c(x) on the H100's peaks
                   (Remark 1), probe-backed or analytic
  service.py       the real-executor AutoML service: trials that train, the
                   GP on their exp(-val_loss), checkpoint and restore
"""

from .control_plane import (  # noqa: F401
    SCORERS,
    ControlPlane,
    TenantHandle,
    no_obs_floor,
    tenant_warm_models,
    warm_start_queue,
)
from .ei import (  # noqa: F401
    choose_next,
    choose_topk_classes,
    ei_matrix,
    ei_total,
    eirate_class_scores,
    eirate_scores,
    eirate_topk_fused,
    expected_improvement,
    single_tenant_ei_scores,
    tau,
    topk_rows_padded,
)
from .gp import BlockIncrementalGP, IncrementalGP, make_gp, posterior_masked  # noqa: F401
from .miu import (  # noqa: F401
    miu_cumulative_exact,
    miu_diag_paper_bound,
    miu_diag_upper_bound,
    miu_greedy,
    miu_s_exact,
)
from .regret import RegretCurves, final_regret, regret_curves, speedup_to_threshold  # noqa: F401
from .scheduler import POLICIES, FailureEvent, SimResult, TrialRecord, simulate  # noqa: F401
from .sim_batched import BatchResult, EpisodeSpec, simulate_batch  # noqa: F401
from .service import (  # noqa: F401
    AutoMLService,
    RealExecutor,
    ServiceConfig,
    ServiceTrial,
    TenantSpec,
    estimate_prior,
)
from .tenancy import (  # noqa: F401
    Problem,
    azure_problem,
    deeplearning_problem,
    matern52,
    synthetic_matern_problem,
    synthetic_matern_z,
)
