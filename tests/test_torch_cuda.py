"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode).  The file imports neither JAX nor the JAX package, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the kernels do the plain versions' arithmetic step for step
(no multiply-add contraction, sums in ascending order, elementary functions
taken in double and rounded once), so both are held bit-equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ControlPlane, simulate, synthetic_matern_problem  # noqa: E402
from repro_torch.core.tenancy import _matern_block_chol  # noqa: E402
from repro_torch.devplane import DevPlaneEngine, two_class_registry  # noqa: E402
from repro_torch.kernels import ei_score, gp_readout, ops, ref  # noqa: E402
from repro_torch.stream import device_churn_trace  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _ei_inputs(rng, n, N, device):
    mu = rng.standard_normal(n).astype(np.float32)
    sg = np.abs(rng.standard_normal(n)).astype(np.float32)
    sg[: n // 4] = 0.0
    best = rng.standard_normal(N).astype(np.float32)
    mem = rng.random((N, n)) < 0.4
    cost = rng.uniform(0.3, 3.0, n).astype(np.float32)
    sel = rng.random(n) < 0.25
    return [torch.from_numpy(a).to(device) for a in (mu, sg, best, mem, cost, sel)]


@pytest.mark.parametrize("n,N", [(2500, 50), (513, 100), (17, 3)])
def test_eirate_kernel_matches_plain(cuda, rng, n, N):
    args = _ei_inputs(rng, n, N, cuda)
    before = ei_score.launches
    got = ops.eirate(*args)
    torch.cuda.synchronize()
    assert ei_score.launches == before + 1
    torch.testing.assert_close(got, ref.eirate_ref(*args), atol=0, rtol=0)


@pytest.mark.parametrize("n,N,k,layout", [
    (2500, 50, 4, "random"), (513, 100, 16, "random"),   # n not a multiple of 256
    (600, 3, 6, "tie"), (3, 2, 8, "random"),              # k > n
])
def test_eirate_topk_kernel_matches_plain(cuda, rng, n, N, k, layout):
    args = _ei_inputs(rng, n, N, cuda)
    if layout == "tie":
        for t, fill in zip(args, (0.0, 1.0, 0.0, True, 1.0, False)):
            t.fill_(fill)
    before = (ei_score.topk_launches, ei_score.launches)
    v, i = ops.eirate_topk(*args, k=k)
    torch.cuda.synchronize()
    assert (ei_score.topk_launches, ei_score.launches) == (before[0] + 1, before[1])
    wv, wi = ref.eirate_topk_ref(*args, k=k)
    torch.testing.assert_close(v, wv, atol=0, rtol=0)
    assert torch.equal(i, wi)
    if layout == "tie":
        assert i.tolist() == list(range(k))
    live = v > -1e29
    assert torch.equal(ops.eirate(*args)[i[live].long()], v[live])


@pytest.mark.parametrize("n,N,C,layout", [
    (2500, 50, 2, "random"), (513, 100, 4, "random"), (17, 3, 1, "random"),
    (600, 3, 3, "tie"), (300, 8, 3, "gate"),
])
def test_eirate_classes_kernel_matches_plain_and_eirate_rows(
        cuda, rng, n, N, C, layout):
    mu, sg, best, mem, cost, sel = _ei_inputs(rng, n, N, cuda)
    rates = torch.from_numpy(rng.uniform(0.5, 4.0, C).astype(np.float32)).to(cuda)
    cm = cost[None, :] / rates[:, None] + 0.25
    if layout == "tie":
        for t, fill in zip((mu, sg, best, mem, sel), (0.0, 1.0, 0.0, True, False)):
            t.fill_(fill)
        cm.fill_(1.0)
    if layout == "gate":
        cm[1, ::3] = float("inf")
    before = (ei_score.classes_launches, ei_score.launches)
    got = ops.eirate_classes(mu, sg, best, mem, cm, sel)
    torch.cuda.synchronize()
    assert (ei_score.classes_launches, ei_score.launches) == \
           (before[0] + 1, before[1])
    torch.testing.assert_close(got, ref.eirate_classes_ref(
        mu, sg, best, mem, cm, sel), atol=0, rtol=0)
    for c in range(C):
        finite = torch.isfinite(cm[c])
        row = ops.eirate(mu, sg, best, mem, torch.where(finite, cm[c], 1.0), sel)
        assert torch.equal(got[c][finite], row[finite])
        assert (got[c][~finite] == ref.NEG_LARGE).all()
    if layout == "tie":
        assert (got == got[0, 0]).all()
    if C == 1:
        assert int(torch.argmax(got[0])) == int(torch.argmax(ops.eirate(
            mu, sg, best, mem, cm[0].contiguous(), sel)))
    with pytest.raises(ValueError):
        ops.eirate_classes(mu, sg, best, mem, cm[:, :-1], sel)
    with pytest.raises(TypeError):
        ops.eirate_classes(mu, sg, best, mem, cm.double(), sel)


def test_devplane_run_on_card_equals_cpu(cuda):
    """A short heterogeneous device-churn run: batched assignment through
    the class kernel on the card gives the CPU run's trials, one class
    launch per scoring pass that found live candidates (a pass over an
    empty pool returns early and launches nothing)."""
    trace = device_churn_trace(
        num_sessions=25, arrival_rate=1.0, seed=2, initial_slices=4,
        join_classes=(("fast", 16, 2.0),), join_rate=0.05, leave_rate=0.1,
        preempt_rate=0.1, m_min=2, m_max=10, session_scale=20.0)
    runs = {}
    for device in (cuda, "cpu"):
        reg = two_class_registry(2.0, overhead=0.5)
        eng = DevPlaneEngine(reg.build_fleet([("slow", 2), ("fast", 2)]),
                             "mdmt", seed=0, registry=reg,
                             launch_order="fastest", max_live_models=60,
                             device=device)
        plane, batch, dry = eng.cp, eng.cp.choose_mdmt_batch, [0]

        def counted(*args, **kw):
            dry[0] += bool(plane.selected.all())
            return batch(*args, **kw)

        plane.choose_mdmt_batch = counted
        before = ei_score.classes_launches
        runs[str(device)] = (eng.run(trace), eng._scoring_passes - dry[0],
                             ei_score.classes_launches - before)
    (gpu, passes, launches), (cpu, _, cpu_launches) = runs["cuda"], runs["cpu"]
    assert gpu.trials == cpu.trials
    assert launches == passes > 0 and cpu_launches == 0


def _churn_picks(plane):
    """A short churn sequence: observations, a retire, an add, a
    compaction and a reshard; returns the picks."""
    rng = np.random.default_rng(1)
    K5 = _matern_block_chol(5, 0.2, 0.04)[0]
    for _ in range(6):
        plane.add_tenant(K5, np.zeros(5), np.ones(5))
    picks = []
    for step in range(30):
        pick = plane.choose_mdmt()
        if pick is None:
            break
        picks.append(pick)
        plane.record_start(pick[0])
        plane.record_observation(pick[0], float(rng.uniform(0, 1)))
        if step == 8:
            plane.retire_tenant(1)
            plane.add_tenant(K5, np.zeros(5), np.linspace(0.5, 2.0, 5))
            plane.compact(1.0)
        if step == 15:
            plane.reshard(2)
    return picks


@pytest.mark.parametrize("kernel", ["eirate_topk", "eirate"])
def test_sharded_plane_on_card_picks_the_ops_sequence(cuda, kernel):
    counts = (ei_score.topk_launches, ei_score.launches)
    ops_picks = _churn_picks(ControlPlane(scorer="ops", num_shards=4,
                                          model_capacity=32, device="cpu"))
    assert (ei_score.topk_launches, ei_score.launches) == counts   # CPU: none
    sharded = ControlPlane(scorer="sharded", num_shards=4, model_capacity=32,
                           score_kernel=kernel, device=cuda)
    assert sharded._sharded.mesh == (cuda,) * 4
    picks = _churn_picks(sharded)
    assert picks == ops_picks and len(picks) == 30
    moved = (ei_score.topk_launches - counts[0], ei_score.launches - counts[1])
    # four shards to step 15, two after the reshard
    want = 4 * 16 + 2 * 14
    assert moved == ((want, 0) if kernel == "eirate_topk" else (0, want))


@pytest.mark.parametrize("k,n", [(0, 50), (50, 50), (512, 2500)])
def test_gp_readout_kernel_matches_plain(cuda, rng, k, n):
    W = torch.from_numpy((rng.standard_normal((k, n)) * 0.3).astype(np.float32)).to(cuda)
    alpha = torch.from_numpy(rng.standard_normal(k).astype(np.float32)).to(cuda)
    mu0 = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    kd = (W * W).sum(0) + 1.0
    before = gp_readout.launches
    for emit_sd in (False, True):
        got = ops.gp_readout(W, alpha, mu0, kd, emit_sd=emit_sd)
        want = ref.gp_readout_ref(W, alpha, mu0, kd, emit_sd=emit_sd)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=0, rtol=0)
    assert gp_readout.launches == before + 2


def test_kernel_wrappers_refuse_bad_inputs(cuda, rng):
    args = _ei_inputs(rng, 64, 4, cuda)
    with pytest.raises(TypeError):
        ops.eirate(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        ops.eirate(*args[:3], args[3][:, :32], *args[4:])
    W = torch.zeros((4, 64), device=cuda)
    with pytest.raises(ValueError):
        ops.gp_readout(W.t(), torch.zeros(64, device=cuda),
                       torch.zeros(4, device=cuda), torch.zeros(4, device=cuda))


@pytest.mark.parametrize("policy", ["mdmt", "round_robin", "random"])
def test_episode_on_card_equals_cpu(cuda, policy):
    prob = synthetic_matern_problem(num_users=6, num_models_per_user=12, seed=3)
    e0, r0 = ei_score.launches, gp_readout.launches
    gpu = simulate(prob, policy, num_devices=3, seed=0, device=cuda)
    assert gp_readout.launches > r0
    if policy == "mdmt":
        assert ei_score.launches > e0
    cpu = simulate(prob, policy, num_devices=3, seed=0, device="cpu")
    assert gpu.trials == cpu.trials
