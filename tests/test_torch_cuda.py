"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode).  The file imports neither JAX nor the JAX package, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the scheduler's kernels do the plain versions' arithmetic step
for step (no multiply-add contraction, sums in ascending order, elementary
functions taken in double and rounded once), so both are held bit-equal.
The data plane's two (flash attention, the SSD scan) sum in other orders
than their plain versions (full-matrix attention, the per-step
recurrence): 2e-4 (absolute and relative) in float32.  Where the output
is bfloat16 both sides compute in float32 and round the output once (at
most one bf16 ulp apart, at most 2^-7 of the value): rtol 1e-2, and an
atol of 1e-3 of the largest |want| for values near 0.  The bf16 routes
split each float32 factor of a product into bf16 hi + lo (about 2^-17 a
term), and are held as well to their arithmetic step for step
(``ref.attention_wgmma_route_ref``, ``ref.ssd_chunked_ref``).  The SSD
output is float32 whatever the route: 2e-4 of each value and 2e-4 of the
largest |want|.  The card's float32 model forward is held to the CPU's at
2e-4 too; in bfloat16, 5e-2 (the two round the products of their own
GEMMs).  Flash attention takes its wgmma route for bf16 inputs and its
tf32x3 route (tf32 wgmma, each product as three TF32 products) for
float32, held as well to its arithmetic tile for tile
(``ref.attention_tf32x3_route_ref``) at 2e-5; the SSD scan takes its
tensor-core route for bf16 and its tf32x3 route (the same chunked products
on tf32 wgmma, three TF32 products each) for float32, held as well to its
arithmetic chunk for chunk (``ref.ssd_tf32x3_route_ref``) at 2e-5; the
tests count both.
"""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    ControlPlane, EpisodeSpec, simulate, simulate_batch, synthetic_matern_problem)
from repro_torch.core.tenancy import _matern_block_chol  # noqa: E402
from repro_torch.devplane import DevPlaneEngine, two_class_registry  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ei_score, gp_readout, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import ssd as ssd_mod  # noqa: E402
from repro_torch.models import forward_logits_last, init_params  # noqa: E402
from repro_torch.models.spec import tree_leaves, tree_map  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.serve import Request, ServeConfig, StaticBatchEngine  # noqa: E402
from repro_torch.stream import device_churn_trace  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _ei_inputs(rng, n, N, device, layout="random"):
    """40% random membership; ``"disjoint"``: one owner a model in ascending
    blocks (the paper's workloads, both main paths); ``"tie"``: all equal;
    ``"order"``: 40% membership with sigma small and best_i = -2^e_i, e_i
    from -20 to 19, so a column's member terms differ in exponent and a
    sum in another than ascending tenant order gives other floats."""
    mu = rng.standard_normal(n).astype(np.float32)
    sg = np.abs(rng.standard_normal(n)).astype(np.float32)
    sg[: n // 4] = 0.0
    best = rng.standard_normal(N).astype(np.float32)
    mem = rng.random((N, n)) < 0.4
    if layout == "disjoint":
        mem = np.zeros((N, n), bool)
        mem[np.arange(n) * N // n, np.arange(n)] = True
    if layout == "order":
        sg = np.full(n, 0.01, np.float32)
        best = -np.exp2(rng.integers(-20, 20, N)).astype(np.float32)
    cost = rng.uniform(0.3, 3.0, n).astype(np.float32)
    sel = rng.random(n) < 0.25
    if layout == "tie":
        mu, sg, best, cost = (np.full_like(a, v) for a, v in
                              ((mu, 0.0), (sg, 1.0), (best, 0.0), (cost, 1.0)))
        mem, sel = np.ones_like(mem), np.zeros_like(sel)
    return [torch.from_numpy(a).to(device) for a in (mu, sg, best, mem, cost, sel)]


def _assert_order_shows(args):
    """The "order" inputs: summing some column's member terms in reverse
    tenant order gives another float32 than the ascending sum."""
    mu, sg, best, mem = (a.cpu() for a in args[:4])
    ei = ref.expected_improvement(mu[None, :], sg[None, :], best[:, None])
    ei = torch.where(mem, ei, torch.zeros_like(ei))
    down = torch.zeros_like(mu)
    for i in reversed(range(ei.shape[0])):
        down = down + ei[i]
    assert not torch.equal(down, ref.ei_total_ref(mu, sg, best, mem))


@pytest.mark.parametrize("n,N,layout", [
    pytest.param(2500, 50, "random", id="2500-50"),
    pytest.param(513, 100, "random", id="513-100"),      # n not a multiple of 16
    pytest.param(17, 3, "random", id="17-3"),            # n below a tile
    pytest.param(2500, 50, "disjoint", id="2500-50-disjoint"),   # Fig-5
    pytest.param(4096, 256, "disjoint", id="4096-256-disjoint"),
    pytest.param(300, 1, "random", id="300-1"),          # N = 1
    pytest.param(700, 33, "random", id="700-33"),        # N not a multiple of 32
    pytest.param(400, 1000, "random", id="400-1000"),    # two slabs, ragged
    pytest.param(600, 70, "order", id="600-70-order"),
    pytest.param(600, 3, "tie", id="600-3-tie"),
    # several tiles a row: 16-, 4- and 1-byte row loads
    pytest.param(10_000, 40, "random", id="10000-40"),
    pytest.param(10_004, 40, "random", id="10004-40"),
    pytest.param(10_001, 300, "disjoint", id="10001-300-disjoint"),
])
def test_eirate_kernel_matches_plain(cuda, rng, n, N, layout):
    args = _ei_inputs(rng, n, N, cuda, layout)
    before = ei_score.launches
    got = ops.eirate(*args)
    torch.cuda.synchronize()
    assert ei_score.launches == before + 1
    torch.testing.assert_close(got, ref.eirate_ref(*args), atol=0, rtol=0)
    if layout == "order":
        _assert_order_shows(args)
    if layout == "tie":
        assert (got == got[0]).all() and int(torch.argmax(got)) == 0


@pytest.mark.parametrize("offset", [1, 4, 16])
def test_eirate_kernels_take_any_membership_base(cuda, rng, offset):
    """membership as a contiguous view at a byte offset: the kernels pick
    their row loads from n and the base (16-, 4- or 1-byte loads)."""
    n, N = 9_008, 37
    mu, sg, best, mem, cost, sel = _ei_inputs(rng, n, N + 1, cuda)
    flat = mem.view(torch.uint8).flatten()
    view = flat[offset:offset + N * n].view(N, n)
    args = [mu, sg, best[:N], view, cost, sel]
    torch.testing.assert_close(ops.eirate(*args), ref.eirate_ref(*args),
                               atol=0, rtol=0)
    cm = torch.stack([cost, cost * 2.0])
    torch.testing.assert_close(
        ops.eirate_classes(mu, sg, best[:N], view, cm, sel),
        ref.eirate_classes_ref(mu, sg, best[:N], view, cm, sel), atol=0, rtol=0)


@pytest.mark.parametrize("n,N,k,layout", [
    (2500, 50, 4, "random"), (513, 100, 16, "random"),   # n not a multiple of 256
    (600, 3, 6, "tie"), (3, 2, 8, "random"),              # k > n
    (700, 128, 8, "fewlive"),      # blocks with fewer live columns than k
    (200, 1, 4, "random"),         # n < 256, one tenant
    (40, 3, 64, "random"),         # n < k: pads
    (1024, 4, 5, "tieblocks"),     # equal values in different blocks
    (2048, 128, 4, "disjoint"),    # a churn shard's shape
    (1000, 1000, 4, "random"),     # N 1,000
])
def test_eirate_topk_kernel_matches_plain(cuda, rng, n, N, k, layout):
    args = _ei_inputs(rng, n, N, cuda)
    if layout == "tie":
        for t, fill in zip(args, (0.0, 1.0, 0.0, True, 1.0, False)):
            t.fill_(fill)
    if layout == "fewlive":
        args[5].fill_(True)
        args[5][::97] = False
    if layout == "tieblocks":      # the top column 10 and its twins in blocks 1-3
        twins = [10, 300, 700, 1000]
        args[0][twins], args[4][twins], args[5][twins] = 50.0, 0.3, False
        args[1][twins] = float(args[1][10])
        args[3][:, twins] = True
    if layout == "disjoint":
        args[3].zero_()
        args[3][torch.arange(n) * N // n, torch.arange(n)] = True
    before = (ei_score.topk_launches, ei_score.launches)
    v, i = ops.eirate_topk(*args, k=k)
    torch.cuda.synchronize()
    assert (ei_score.topk_launches, ei_score.launches) == (before[0] + 1, before[1])
    wv, wi = ref.eirate_topk_ref(*args, k=k)
    torch.testing.assert_close(v, wv, atol=0, rtol=0)
    assert torch.equal(i, wi)
    if layout == "tie":
        assert i.tolist() == list(range(k))
    if layout == "tieblocks":
        assert i[:4].tolist() == [10, 300, 700, 1000] and bool((v[:4] == v[0]).all())
    live = v > -1e29
    assert torch.equal(ops.eirate(*args)[i[live].long()], v[live])


@pytest.mark.parametrize("n,N,C,layout", [
    (2500, 50, 2, "random"), (513, 100, 4, "random"), (17, 3, 1, "random"),
    (600, 3, 3, "tie"), (300, 8, 3, "gate"),
    (4096, 256, 1, "disjoint"), (4096, 256, 2, "disjoint"),   # device churn
    (2500, 50, 1, "disjoint"), (300, 1, 2, "random"), (700, 33, 3, "random"),
    (400, 1000, 2, "random"), (600, 70, 2, "order"),
    (10_000, 40, 4, "random"), (10_001, 300, 2, "disjoint"),
])
def test_eirate_classes_kernel_matches_plain_and_eirate_rows(
        cuda, rng, n, N, C, layout):
    mu, sg, best, mem, cost, sel = _ei_inputs(
        rng, n, N, cuda, "random" if layout in ("tie", "gate") else layout)
    if layout == "order":
        _assert_order_shows([mu, sg, best, mem])
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


def _forensic_picks(plane, tie: bool):
    """Decisions of a plane with a forensics recorder: picks and records.
    ``tie``: identical tenants (every decision an exact tie at first)."""
    from repro_torch.obs import ForensicsRecorder
    rng = np.random.default_rng(2)
    K5 = _matern_block_chol(5, 0.2, 0.04)[0]
    for t in range(6):
        plane.add_tenant(K5, np.zeros(5) if tie else rng.normal(0, 0.1, 5),
                         np.ones(5) if tie else np.linspace(0.5, 2.0, 5))
    fr = ForensicsRecorder()
    plane.set_forensics(fr)
    picks = []
    for step in range(20):
        fr.begin_event(float(step), step)
        pick = plane.choose_mdmt(device_speed=1.0 if step % 2 else 2.0)
        picks.append(pick)
        plane.record_start(pick[0])
        plane.record_observation(pick[0], float(rng.uniform(0, 1)))
    return picks, fr.records


@pytest.mark.parametrize("tie", [True, False])
@pytest.mark.parametrize("scorer", ["ops", "sharded"])
def test_forensics_topk_head_is_the_decision_on_card(cuda, scorer, tie):
    """Forensics on the card: the ops path takes its top-4 from the scores
    kernel 2 computed for the decision (no extra launch), the sharded path
    keeps kernel 3's top-k; the head is the pick, and the picks and the
    records' candidates are the CPU plane's."""
    cpu_picks, cpu_recs = _forensic_picks(
        ControlPlane(scorer="ops", num_shards=4, model_capacity=32,
                     device="cpu"), tie)
    counts = (ei_score.launches, ei_score.topk_launches)
    plane = ControlPlane(scorer=scorer, num_shards=4, model_capacity=32,
                         device=cuda)
    picks, recs = _forensic_picks(plane, tie)
    moved = (ei_score.launches - counts[0],
             ei_score.topk_launches - counts[1])
    assert picks == cpu_picks
    assert moved == ((20, 0) if scorer == "ops" else (0, 4 * 20))
    assert [r["winner"]["model"] for r in recs] == [p[0] for p in picks]
    assert [[c["model"] for c in r["topk"]] for r in recs] == \
        [[c["model"] for c in r["topk"]] for r in cpu_recs]
    if tie:
        assert recs[0]["winner"]["model"] == 0 and recs[0]["margin"] == 0.0


@pytest.mark.parametrize("kernel", ["eirate_topk", "eirate"])
def test_phased_pick_equals_fused_pick_on_card(cuda, rng, kernel):
    """readout_decide_topk_phased on the card: the fused pick and top-k,
    the three phase spans, one readout and one score launch a shard."""
    from repro_torch.obs import Tracer
    from repro_torch.shardgp import ShardedScorer
    k_obs, n, N = 256, 8192, 64
    W = torch.from_numpy((rng.standard_normal((k_obs, n)) * 0.05)
                         .astype(np.float32)).to(cuda)
    alpha = torch.from_numpy(rng.standard_normal(k_obs).astype(np.float32)
                             ).to(cuda)
    mu0 = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    kd = (W * W).sum(0) + 1.0
    member = np.zeros((N, n), bool)
    member[np.arange(n) * N // n, np.arange(n)] = True
    cost = rng.uniform(0.3, 3.0, n).astype(np.float32)
    best = rng.normal(0.5, 0.5, N).astype(np.float32)
    sel = torch.from_numpy(rng.random(n) < 0.25).to(cuda)
    sc = ShardedScorer(4, topk=4, kernel=kernel, device=cuda)
    sc.refresh(member, cost)
    tr = Tracer(enabled=True)
    sc.tracer = tr
    v, g = sc.readout_decide_topk(W, alpha, mu0, kd, best, sel)
    before = (gp_readout.launches, ei_score.launches, ei_score.topk_launches)
    pv, pg = sc.readout_decide_topk_phased(W, alpha, mu0, kd, best, sel)
    moved = (gp_readout.launches - before[0], ei_score.launches - before[1],
             ei_score.topk_launches - before[2])
    assert torch.equal(v, pv) and torch.equal(g, pg)
    assert moved == ((4, 0, 4) if kernel == "eirate_topk" else (4, 4, 0))
    assert [r["name"] for r in tr.records()] == \
        ["readout", "score_topk", "gather_pick"]
    mu, sd = ops.gp_readout(W, alpha, mu0, kd, emit_sd=True)
    scores = ops.eirate(mu, sd, torch.from_numpy(best).to(cuda),
                        torch.from_numpy(member).to(cuda),
                        torch.from_numpy(cost).to(cuda), sel)
    assert int(pg[0]) == int(torch.argmax(scores))
    times = sc.phase_times(W, alpha, mu0, kd, best, sel, iters=3, warmup=1)
    assert set(times) == {"readout_us", "score_us", "gather_us"}


@pytest.mark.parametrize("k,n,offset,width,path", [
    (0, 50, None, None, "slab"),
    (50, 50, None, None, "slab"),
    (7, 45, None, None, "slab"),                # n no multiple of 4
    (512, 2500, None, None, "column"),
    (1024, 100_000, None, None, "bulk"),        # service size
    (300, 40_001, None, None, "column"),        # n no multiple of 4
    (256, 40_000, 1, None, "column"),           # column slices of a wider W at 1,
    (256, 40_000, 2, None, "column"),           # 2 and 4 columns in: only the
    (256, 40_000, 4, None, "bulk"),             # last starts 16-byte aligned
    (1024, 25_000, 25_000, 100_000, "bulk_deep"),   # a shard's slice, 4 shards
    (300, 8192, 4, 8200, "bulk_deep"),          # k no multiple of the deep stage
    (5, 50, 3, None, "slab"),                   # a slice in the slab: 4-byte copies
    (2, 3000, None, None, "slab"),              # more columns than the slab's threads
])
def test_gp_readout_kernel_matches_plain(cuda, rng, k, n, offset, width, path):
    """Bit-equal to the plain version on every path; ``offset``: W is the
    columns [offset, offset + n) of a (k, width) buffer (default n + 8).
    The path is the one the wrapper counts its launches on."""
    if offset is None:
        width = n
    elif width is None:
        width = n + 8       # 40,008 columns: rows 16-byte aligned
    W = torch.from_numpy((rng.standard_normal((k, width)) * 0.3).astype(np.float32)).to(cuda)
    if offset is not None:
        W = W[:, offset:offset + n]
    alpha = torch.from_numpy(rng.standard_normal(k).astype(np.float32)).to(cuda)
    mu0 = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    kd = (W * W).sum(0) + 1.0
    before = gp_readout.launches
    by_path = dict(gp_readout.launches_by_path)
    for emit_sd in (False, True):
        got = ops.gp_readout(W, alpha, mu0, kd, emit_sd=emit_sd)
        want = ref.gp_readout_ref(W, alpha, mu0, kd, emit_sd=emit_sd)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=0, rtol=0)
    assert gp_readout.launches == before + 2
    assert {p: c - by_path[p] for p, c in gp_readout.launches_by_path.items()} == {
        p: 2 if p == path else 0 for p in gp_readout.PATHS}


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


def test_sweep_graph_on_card_equals_cpu(cuda):
    """``simulate_batch`` on the card, where step 0 runs eagerly and steps 1
    to T - 1 replay one CUDA graph, returns the CPU's eager result bit for
    bit in every field, in two calls (a graph each); T = 43 ends inside the
    second chunk of ``random`` Gumbels.  The ``loop`` span counts the
    replayed steps and has one ``capture`` child."""
    prob = synthetic_matern_problem(num_users=5, num_models_per_user=8, seed=5)
    specs = [EpisodeSpec("mdmt", 3, 0, device_speeds=(1.0, 2.0, 0.5)),
             EpisodeSpec("round_robin", 2, 1), EpisodeSpec("random", 3, 2),
             EpisodeSpec("random", 1, 9), EpisodeSpec("mdmt", 1, 4)]
    T = prob.num_models + 3
    want = simulate_batch(prob, specs, device="cpu")
    tracer = Tracer(enabled=True)
    tracer.begin_trace(0)
    runs = [simulate_batch(prob, specs, device=cuda, tracer=tracer),
            simulate_batch(prob, specs, device=cuda)]
    for got in runs:
        for f in dataclasses.fields(want):
            a, b = getattr(want, f.name), getattr(got, f.name)
            if f.name == "wall_seconds":
                continue
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), f.name
            else:
                assert a is b or a == b, f.name
    spans = {r["name"]: r for r in tracer.records()}
    assert [r["name"] for r in tracer.records()].count("capture") == 1
    loop = spans["loop"]
    assert loop["attrs"] == {"steps": T, "graph_steps": T - 1, "eager_steps": 1}
    assert spans["capture"]["parent"] == loop["span"]


# --- the data plane ---------------------------------------------------------------

F32 = dict(atol=2e-4, rtol=2e-4)


def _assert_close(got, want):
    """F32 for float32 output; for bf16 output rtol 1e-2 (one bf16 ulp is at
    most 2^-7 of the value) and an atol of 1e-3 of max |want|."""
    if want.dtype != torch.bfloat16:
        torch.testing.assert_close(got, want, **F32)
        return
    assert got.dtype == torch.bfloat16
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=1e-2,
                               atol=1e-3 * float(want.abs().max()))


# the float32 route against its own arithmetic (ref.attention_tf32x3_route_ref):
# both take each product as three TF32 products and differ only in the order
# of the sums and in the exp (base 2 on MUFU.EX2 in the kernel): 2e-5 of each
# value and 2e-5 of max |want|, a tenth of the float32 tolerance
ROUTE_F32 = 2e-5


def _assert_route(got, want):
    torch.testing.assert_close(got, want, rtol=ROUTE_F32,
                               atol=ROUTE_F32 * float(want.abs().max()))


@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,dtype,causal", [
    (2, 128, 4, 4, 32, None, torch.float32, True),      # MHA
    (1, 200, 8, 2, 120, None, torch.float32, True),     # D 120, S no multiple of 64
    (2, 256, 4, 2, 64, 64, torch.float32, True),        # sliding window
    (1, 100, 4, 1, 80, None, torch.bfloat16, True),     # MQA, D 80
    (1, 130, 8, 2, 128, 48, torch.bfloat16, True),      # GQA 4:1, window, ragged S
    (1, 1, 2, 1, 16, None, torch.float32, True),        # one step
    (2, 77, 4, 2, 64, None, torch.float32, False),      # not causal
    (1, 150, 4, 2, 256, None, torch.float32, True),     # D 256 (32-key tiles)
    (1, 300, 2, 1, 256, 100, torch.float32, False),     # D 256, a window, not causal
    # the other families' shapes: zamba2's shared block (32/32, D 80) and
    # paligemma (8/1, D 256), each in bf16 and float32
    (1, 256, 32, 32, 80, None, torch.bfloat16, True),
    (1, 256, 32, 32, 80, None, torch.float32, True),
    (1, 320, 8, 1, 256, None, torch.bfloat16, True),
    (1, 320, 8, 1, 256, None, torch.float32, True),
])
def test_flash_attention_kernel_matches_plain(cuda, rng, B, S, Hq, Hkv, D, window, dtype,
                                              causal):
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, h, D)).astype(np.float32))
               .to(cuda, dtype) for h in (Hq, Hkv, Hkv))
    before = flash_mod.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_mod.launches == before + 1 and got.dtype == dtype
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    _assert_close(got, want)
    if dtype == torch.float32:
        _assert_route(got, ref.attention_tf32x3_route_ref(q, k, v, causal=causal,
                                                          window=window))


def _flash_routes(fn):
    """fn's flash launches by route."""
    before = dict(flash_mod.launches_by_route)
    out = fn()
    torch.cuda.synchronize()
    return out, {r: c - before[r] for r, c in flash_mod.launches_by_route.items()}


@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,causal", [
    (1, 64, 4, 4, 16, None, True),       # MHA, D 16
    (2, 63, 4, 2, 24, None, True),       # D 24, S one short of a tile of 64
    (1, 130, 8, 2, 80, None, True),      # D 80, S past a 128-row tile
    (1, 200, 8, 2, 120, 48, True),       # h2o's D 120 with a window
    (1, 2048, 8, 2, 128, None, True),    # qwen3's D 128, GQA 4:1, S 2,048
    (1, 1, 4, 1, 128, None, True),       # one step
    (2, 77, 4, 2, 64, None, False),      # not causal
    (1, 300, 2, 1, 256, 100, False),     # D 256, a window, not causal
])
def test_flash_bf16_takes_the_wgmma_route(cuda, rng, B, S, Hq, Hkv, D, window, causal):
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, h, D)).astype(np.float32))
               .to(cuda, torch.bfloat16) for h in (Hq, Hkv, Hkv))
    got, routes = _flash_routes(
        lambda: ops.flash_attention(q, k, v, causal=causal, window=window))
    assert routes == {"wgmma": 1, "tf32x3": 0} and got.dtype == torch.bfloat16
    _assert_close(got, ref.attention_ref(q, k, v, causal=causal, window=window))
    _assert_close(got, ref.attention_wgmma_route_ref(q, k, v, causal=causal,
                                                     window=window))


def test_flash_float32_takes_the_tf32x3_route(cuda, rng):
    q = torch.from_numpy(rng.standard_normal((1, 100, 4, 64)).astype(np.float32)).to(cuda)
    got, routes = _flash_routes(lambda: ops.flash_attention(q, q[:, :, :2], q[:, :, 2:]))
    assert routes == {"wgmma": 0, "tf32x3": 1}
    _assert_close(got, ref.attention_ref(q, q[:, :, :2], q[:, :, 2:]))
    _assert_route(got, ref.attention_tf32x3_route_ref(q, q[:, :, :2], q[:, :, 2:]))


@pytest.mark.parametrize("D", [120, 128])
def test_flash_bf16_takes_views_of_a_fused_projection(cuda, rng, D):
    """q, k and v as views of one bf16 (B, S, Hq + 2 Hkv, D) projection:
    strides of (Hq + 2 Hkv) D elements per step, bases D elements apart."""
    qkv = torch.from_numpy(rng.standard_normal((2, 150, 12, D)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    got, routes = _flash_routes(lambda: ops.flash_attention(q, k, v))
    assert routes == {"wgmma": 1, "tf32x3": 0}
    _assert_close(got, ref.attention_ref(q, k, v))


def test_flash_bf16_refuses_what_tma_cannot_copy(cuda):
    """A base or a stride that is no multiple of 16 bytes raises with the
    reason; nothing is sent to the float32 kernel or to a library."""
    before = dict(flash_mod.launches_by_route)
    x = torch.zeros((1, 64, 4, 40), device=cuda, dtype=torch.bfloat16)
    q = x[..., 1:33]                                   # base 2 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(q, q, q)
    y = torch.zeros((1, 64, 4, 20), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16 bytes"):  # head stride 40 bytes
        ops.flash_attention(y, y, y)
    assert flash_mod.launches_by_route == before


@pytest.mark.parametrize("offset", [0, 1])
def test_flash_float32_takes_views_at_any_offset(cuda, rng, offset):
    """float32 q, k and v as views of one fused projection whose rows are
    1,444 floats apart, starting ``offset`` floats in: at 0 every row
    segment is 16-byte aligned (16-byte copies), at 1 none is (4-byte
    copies).  The float32 route has no alignment rule."""
    buf = torch.from_numpy(rng.standard_normal((2, 150, 12 * 120 + 4)).astype(
        np.float32)).to(cuda)
    qkv = buf[..., offset:offset + 12 * 120].unflatten(-1, (12, 120))
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    got, routes = _flash_routes(lambda: ops.flash_attention(q, k, v, window=64))
    assert routes == {"wgmma": 0, "tf32x3": 1}
    _assert_close(got, ref.attention_ref(q, k, v, window=64))
    _assert_route(got, ref.attention_tf32x3_route_ref(q, k, v, window=64))


def test_flash_attention_kernel_takes_strided_inputs(cuda, rng):
    """q, k, v as views of one fused projection (unit stride along D only)."""
    qkv = torch.from_numpy(rng.standard_normal((2, 96, 8, 32)).astype(np.float32)).to(cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = ops.flash_attention(q, k, v)
    torch.testing.assert_close(got, ref.attention_ref(q, k, v), **F32)


def _ssd_inputs(rng, B, S, H, P, N, dtype, device):
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (B, S, H)).astype(np.float32)
    la = (-dt * rng.uniform(0.5, 2.0, (1, 1, H))).astype(np.float32)
    b = rng.standard_normal((B, S, N)).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    t = [torch.from_numpy(a).to(device) for a in (x, dt, la, b, c)]
    return [t[0].to(dtype), t[1], t[2], t[3].to(dtype), t[4].to(dtype)]


@pytest.mark.parametrize("B,S,H,P,N,chunk,dtype", [
    (2, 64, 2, 16, 8, 16, torch.float32),
    (1, 300, 3, 64, 128, 128, torch.float32),     # last chunk short
    (2, 96, 4, 32, 16, 256, torch.float32),       # a single chunk
    (1, 128, 2, 64, 64, 64, torch.bfloat16),      # bf16 x, B, C
    (1, 70, 2, 128, 32, 32, torch.float32),       # P 128
])
def test_ssd_kernel_matches_plain(cuda, rng, B, S, H, P, N, chunk, dtype):
    args = _ssd_inputs(rng, B, S, H, P, N, dtype, cuda)
    before = ssd_mod.launches
    got = ops.ssd_mix(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_mod.launches == before + 1 and got.dtype == torch.float32
    # the inputs are the same values in both and both compute in float32
    torch.testing.assert_close(got, ref.ssd_ref(*args), **F32)


def _assert_ssd_close(got, want):
    """The SSD output (float32) within 2e-4 of each value and 2e-4 of the
    largest |want| (chip_smoke.py's DATA_TOL for float32)."""
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4 * float(want.abs().max()))


def _ssd_routes(fn):
    """fn's SSD calls by route."""
    before = dict(ssd_mod.launches_by_route)
    out = fn()
    torch.cuda.synchronize()
    return out, {r: c - before[r] for r, c in ssd_mod.launches_by_route.items()}


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 64, 2, 16, 8, 16),        # chunks of 16: four to a 64-step slab
    (1, 300, 3, 64, 128, 128),    # last chunk short
    (2, 96, 4, 32, 16, 256),      # a single chunk, Q = S = 96
    (1, 128, 2, 64, 64, 64),
    (1, 70, 2, 128, 32, 32),      # P 128: two warpgroups for the states
    (2, 1000, 2, 64, 128, 1000),  # one chunk of 1,000 steps (Q = S)
    (1, 2048, 4, 64, 128, 256),   # mamba2-1.3b's widths, four heads
    (2, 96, 4, 32, 16, 32),       # mamba2-1.3b's smoke config
    (1, 200, 3, 40, 72, 64),      # P, N no multiple of 16
    (1, 1, 2, 64, 128, 256),      # one step
])
def test_ssd_tensor_cores_match_plain(cuda, rng, B, S, H, P, N, chunk):
    """The bf16 route against its arithmetic step for step and against the
    per-step recurrence."""
    args = _ssd_inputs(rng, B, S, H, P, N, torch.bfloat16, cuda)
    got, routes = _ssd_routes(lambda: ops.ssd_mix(*args, chunk=chunk))
    assert routes == {"tensor_cores": 1, "tf32x3": 0}
    _assert_ssd_close(got, ref.ssd_chunked_ref(*args, chunk=chunk))
    _assert_ssd_close(got, ref.ssd_ref(*args))


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 300, 3, 64, 128, 128),    # last chunk short; odd H: one head an output block
    (2, 96, 4, 32, 16, 32),       # mamba2-1.3b's smoke config
    (1, 513, 4, 64, 128, 513),    # serve's check: one chunk, Q = S = 513
    (2, 2048, 4, 64, 128, 256),   # mamba2-1.3b's widths, eight chunks
    (1, 70, 2, 128, 32, 32),      # P 128: two 64-column halves
    (1, 100, 2, 30, 18, 32),      # P, N no multiple of 4: 4-byte copies
    (1, 1, 2, 64, 128, 256),      # one step
])
def test_ssd_float32_takes_the_tf32x3_route(cuda, rng, B, S, H, P, N, chunk):
    """The float32 route against its arithmetic chunk for chunk (2e-5) and
    against the per-step recurrence (2e-4)."""
    args = _ssd_inputs(rng, B, S, H, P, N, torch.float32, cuda)
    got, routes = _ssd_routes(lambda: ops.ssd_mix(*args, chunk=chunk))
    assert routes == {"tensor_cores": 0, "tf32x3": 1}
    _assert_route(got, ref.ssd_tf32x3_route_ref(*args, chunk=chunk))
    _assert_ssd_close(got, ref.ssd_ref(*args))


@pytest.mark.parametrize("H,P,N,S", [(64, 64, 128, 512), (4, 32, 16, 96)])
def test_ssd_tensor_cores_take_views_of_a_fused_projection(cuda, rng, H, P, N, S):
    """x, b and c as views of one bf16 (B, S, H P + 2 N) projection, as
    ``models/ssm.py`` makes them (mamba2-1.3b's widths and its smoke
    config's): a step stride of H P + 2 N elements, b and c's bases H P and
    H P + N elements into the row."""
    xbc = torch.from_numpy(rng.standard_normal((2, S, H * P + 2 * N)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    x = xbc[..., :H * P].unflatten(-1, (H, P))
    b, c = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, (2, S, H)).astype(np.float32)).to(cuda)
    la = -dt * 1.3
    got, routes = _ssd_routes(lambda: ops.ssd_mix(x, dt, la, b, c, chunk=256))
    assert routes == {"tensor_cores": 1, "tf32x3": 0}
    _assert_ssd_close(got, ref.ssd_chunked_ref(x, dt, la, b, c, chunk=256))
    _assert_ssd_close(got, ref.ssd_ref(x, dt, la, b, c))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("H,P,N,S", [(64, 64, 128, 512), (4, 32, 16, 96)])
def test_ssd_float32_takes_views_of_a_fused_projection(cuda, rng, H, P, N, S, offset):
    """float32 x, b and c as views of one (B, S, H P + 2 N) projection, as
    ``models/ssm.py`` makes them, starting ``offset`` floats into a wider
    buffer: at 0 every row segment is 16-byte aligned (16-byte copies), at
    1 only 4-byte aligned (4-byte copies).  The float32 route has no
    alignment rule."""
    buf = torch.from_numpy(rng.standard_normal((2, S, H * P + 2 * N + 4)).astype(
        np.float32)).to(cuda)
    xbc = buf[..., offset:offset + H * P + 2 * N]
    x = xbc[..., :H * P].unflatten(-1, (H, P))
    b, c = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, (2, S, H)).astype(np.float32)).to(cuda)
    la = -dt * 1.3
    got, routes = _ssd_routes(lambda: ops.ssd_mix(x, dt, la, b, c, chunk=256))
    assert routes == {"tensor_cores": 0, "tf32x3": 1}
    _assert_route(got, ref.ssd_tf32x3_route_ref(x, dt, la, b, c, chunk=256))
    _assert_ssd_close(got, ref.ssd_ref(x, dt, la, b, c))


def test_ssd_bf16_refuses_what_tma_cannot_copy(cuda, rng):
    """A base or a stride that is no multiple of 16 bytes raises with the
    reason; nothing is sent to the float32 kernel."""
    x, dt, la, b, c = _ssd_inputs(rng, 1, 64, 2, 32, 16, torch.bfloat16, cuda)
    before = dict(ssd_mod.launches_by_route)
    wide = torch.zeros((1, 64, 2, 40), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        ops.ssd_mix(wide[..., 1:33], dt, la, b, c)
    with pytest.raises(ValueError, match="16 bytes"):     # head stride 40 bytes
        ops.ssd_mix(torch.zeros((1, 64, 2, 20), device=cuda, dtype=torch.bfloat16),
                    dt, la, b, c)
    with pytest.raises(ValueError, match="16 bytes"):     # step stride 20 bytes
        b10 = torch.zeros((1, 64, 10), device=cuda, dtype=torch.bfloat16)
        ops.ssd_mix(x, dt, la, b10, b10)
    with pytest.raises(ValueError, match="N 256"):        # N beyond the route
        b256 = torch.zeros((1, 64, 256), device=cuda, dtype=torch.bfloat16)
        ops.ssd_mix(x, dt, la, b256, b256)
    assert ssd_mod.launches_by_route == before


def test_data_plane_wrappers_refuse_bad_inputs(cuda, rng):
    q = torch.zeros((1, 64, 4, 32), device=cuda)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        ops.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError):                 # Hq not a multiple of Hkv
        ops.flash_attention(q, q[:, :, :3], q[:, :, :3])
    big = torch.zeros((1, 8, 1, 272), device=cuda)
    with pytest.raises(ValueError):                 # D beyond the kernel
        ops.flash_attention(big, big, big)
    with pytest.raises(ValueError):                 # D not unit stride
        ops.flash_attention(q.transpose(2, 3)[:, :, :4, :4], q[:, :, :4, :4],
                            q[:, :, :4, :4])
    x, dt, la, b, c = _ssd_inputs(rng, 1, 32, 2, 16, 8, torch.float32, cuda)
    with pytest.raises(TypeError):
        ops.ssd_mix(x, dt.double(), la, b, c)
    with pytest.raises(TypeError):
        ops.ssd_mix(x, dt, la, b.bfloat16(), c)
    with pytest.raises(ValueError):
        ops.ssd_mix(x, dt, la, b[:, :16], c[:, :16])
    with pytest.raises(ValueError):
        ops.ssd_mix(x, dt, la, b.cpu(), c)
    wide = torch.zeros((1, 32, 2, 160), device=cuda)
    with pytest.raises(ValueError):                 # P beyond the kernel
        ops.ssd_mix(wide, dt, la, b, c)
    b256 = torch.zeros((1, 32, 256), device=cuda)
    before = dict(ssd_mod.launches_by_route)
    with pytest.raises(ValueError, match="N 256"):  # N beyond the float32 route
        ops.ssd_mix(x, dt, la, b256, b256)
    assert ssd_mod.launches_by_route == before


def _to(tree, device):
    return tree_map(lambda t: t.to(device), tree, lambda x: isinstance(x, torch.Tensor))


@pytest.mark.parametrize("arch,dtype", [
    ("qwen3-4b", torch.float32), ("h2o-danube-3-4b", torch.float32),
    ("olmo-1b", torch.float32), ("mamba2-1.3b", torch.float32),
    ("mamba2-1.3b", torch.bfloat16)])
def test_smoke_forward_on_card_equals_cpu(cuda, arch, dtype):
    """The smoke config: the card's forward (flash or SSD kernel in every
    layer, on the dtype's route) gives the CPU's last logits (plain
    versions): 2e-4 in float32; in bf16 (the config's own dtype), 5e-2."""
    smoke = get_smoke_config(arch)
    cfg = dataclasses.replace(
        smoke, compute_dtype=dtype, use_pallas=True,
        ssm=smoke.ssm._replace(use_pallas=True) if smoke.ssm is not None else None)
    params = init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 96)).astype(np.int32))
    want = forward_logits_last(params, {"tokens": tokens}, cfg)
    f0, s0 = flash_mod.launches, ssd_mod.launches
    got, routes = _ssd_routes(
        lambda: forward_logits_last(_to(params, cuda), {"tokens": tokens.to(cuda)}, cfg))
    kernel = ssd_mod.launches - s0 if cfg.family == "ssm" else flash_mod.launches - f0
    assert kernel == cfg.num_layers
    if cfg.family == "ssm":
        assert routes[ssd_mod.route(dtype)] == cfg.num_layers
    tol = F32 if dtype == torch.float32 else dict(atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(got.cpu().float(), want.float(), **tol)


def test_moe_smoke_forward_on_card_equals_cpu(cuda):
    """qwen3-moe's smoke config in float32: the card's forward (flash in
    every layer) gives the CPU's last logits and loss to 2e-4, with the same
    expert ids and keep masks in every routing."""
    from repro_torch.models import forward_loss
    from repro_torch.models import moe as moe_mod
    smoke = get_smoke_config("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(smoke, compute_dtype=torch.float32, use_pallas=True)
    params = init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32))
             for k in ("tokens", "labels")}
    route = moe_mod._route
    out = {}
    for dev, p in (("cpu", params), ("cuda", _to(params, cuda))):
        log = []

        def recording(w, x, c, log=log):
            gates, ids, aux = route(w, x, c)
            log.append((ids.cpu(), moe_mod.dispatch(ids, c, c.capacity)[1].cpu()))
            return gates, ids, aux
        moe_mod._route = recording
        try:
            b = {k: v.to(dev) for k, v in batch.items()}
            f0 = flash_mod.launches
            logits = forward_logits_last(p, {"tokens": b["tokens"]}, cfg)
            loss = forward_loss(p, b, cfg)
            assert flash_mod.launches - f0 == (2 * cfg.num_layers if dev == "cuda" else 0)
        finally:
            moe_mod._route = route
        out[dev] = (logits.cpu(), loss.cpu(), log)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], **F32)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], **F32)
    assert len(out["cuda"][2]) == len(out["cpu"][2]) == 2 * cfg.num_layers
    for (a, b), (c, d) in zip(out["cuda"][2], out["cpu"][2]):
        assert torch.equal(a, c) and torch.equal(b, d)


def test_hybrid_prefill_and_decode_on_card_equal_cpu(cuda):
    """zamba2's smoke config in float32: prefill (the nested cache) and one
    decode step on the card give the CPU's hidden state, cache and logits
    to 2e-4; the full forward's kernels on the card (an SSD call a Mamba2
    layer, a flash call a group) give the CPU's last logits too."""
    from repro_torch.models import decode_step, prefill
    smoke = get_smoke_config("zamba2-2.7b")
    cfg = dataclasses.replace(smoke, compute_dtype=torch.float32, use_pallas=True,
                              ssm=smoke.ssm._replace(use_pallas=True))
    params = init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 48)).astype(np.int32))
    out = {}
    for dev, p in (("cpu", params), ("cuda", _to(params, cuda))):
        t = tokens.to(dev)
        h, cache = prefill(p, {"tokens": t[:, :-1]}, cfg, max_len=56)
        logits, cache2 = decode_step(p, {"tokens": t[:, -1:]}, cache, cfg)
        f0, s0 = flash_mod.launches, ssd_mod.launches
        fwd = forward_logits_last(p, {"tokens": t}, cfg)
        launched = (flash_mod.launches - f0, ssd_mod.launches - s0)
        assert launched == ((cfg.num_attn_layers, cfg.num_layers) if dev == "cuda"
                            else (0, 0))
        out[dev] = _to((h, cache2, logits, fwd), "cpu")
    assert out["cuda"][1]["ssm"]["state"].shape[:2] == (2, 2)    # (groups, k)
    for got, want in zip(tree_leaves(out["cuda"]), tree_leaves(out["cpu"])):
        assert got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), **F32)


def test_engine_on_card_equals_cpu(cuda):
    """The serving engine on the card emits the CPU engine's tokens (float32)."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"), compute_dtype=torch.float32)
    params = init_params(cfg, 0, device="cpu")
    out = {}
    for dev, p in (("cpu", params), ("cuda", _to(params, cuda))):
        eng = StaticBatchEngine(cfg, p, ServeConfig(batch_slots=2, max_len=128),
                                device=dev)
        rng = np.random.default_rng(1)
        for i in range(3):
            eng.submit(Request(i, rng.integers(0, 255, 6 + 3 * i).astype(np.int32),
                               max_new_tokens=5))
        out[dev] = [r.output for r in eng.run()]
    assert out["cuda"] == out["cpu"]


def test_kernel_route_raises_under_autograd_on_card(cuda):
    """The flash and SSD kernels have no backward pass: with an input that
    requires grad they raise on the card (as on the CPU) and launch
    nothing; under no_grad they launch."""
    q = torch.zeros((1, 64, 2, 64), device=cuda, requires_grad=True)
    x = torch.zeros((1, 64, 2, 64), device=cuda, requires_grad=True)
    dt = torch.zeros((1, 64, 2), device=cuda)
    bc = torch.zeros((1, 64, 16), device=cuda)
    f0, s0 = flash_mod.launches, ssd_mod.launches
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, q.detach(), q.detach())
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd_mix(x, dt, dt, bc, bc)
    assert (flash_mod.launches, ssd_mod.launches) == (f0, s0)
    with torch.no_grad():
        ops.flash_attention(q, q, q)
        ops.ssd_mix(x, dt, dt, bc, bc)
    assert (flash_mod.launches, ssd_mod.launches) == (f0 + 1, s0 + 1)


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-1.3b"])
def test_train_step_on_card_equals_cpu(cuda, arch):
    """Three float32 train steps of the smoke config (the plain route, no
    kernel launch) on the card and on the CPU: losses to rtol 1e-5, every
    parameter within 2e-2 of the learning rates summed over the steps (an
    element's AdamW step is at most about lr, and g / (|g| + eps) passes a
    gradient's float32 error on where |g| is near eps), as the CPU tests
    hold the port's steps to the reference's."""
    from repro_torch.models.spec import tree_leaves
    from repro_torch.train import OptConfig, TrainState, adamw_init, make_train_step

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=torch.float32)
    opt_cfg = OptConfig(lr=5e-3, warmup_steps=2, total_steps=10)
    rng = np.random.default_rng(0)
    batches = [{k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32))
                for k in ("tokens", "labels")} for _ in range(3)]
    out = {}
    f0, s0 = flash_mod.launches, ssd_mod.launches
    for dev in ("cpu", cuda):
        params = _to(init_params(cfg, 0, device="cpu"), dev)
        state = TrainState(params, adamw_init(params, opt_cfg))
        step = make_train_step(cfg, opt_cfg)
        losses, lr_sum = [], 0.0
        for b in batches:
            state, met = step(state, {k: v.to(dev) for k, v in b.items()})
            losses.append(float(met["loss"]))
            lr_sum += float(met["lr"])
        out[str(dev)] = (losses, tree_leaves(_to(state.params, "cpu"),
                                             lambda x: isinstance(x, torch.Tensor)))
    assert (flash_mod.launches, ssd_mod.launches) == (f0, s0)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for g, w in zip(out["cuda"][1], out["cpu"][1]):
        assert float((g - w).abs().max()) <= 2e-2 * lr_sum


def test_service_decisions_on_card_equal_cpu(cuda):
    """The service's decisions on the card (the readout kernel, once a
    decision) take the CPU's trials, for every policy."""
    from repro_torch.core.fleet import Fleet
    from repro_torch.core.service import AutoMLService, ServiceConfig, TenantSpec

    archs = ["olmo-1b", "qwen3-4b", "mamba2-1.3b"]

    class Table:
        def run(self, tenant, arch):
            return 0.3 + 0.1 * ((tenant.tenant_id + archs.index(arch)) % 3), 1.0

    for policy in ("mdmt", "round_robin", "random"):
        runs = {}
        for dev in ("cpu", cuda):
            svc = AutoMLService([TenantSpec(i, i, 1.2) for i in range(3)], archs,
                                Fleet.partition_pod(256, 2), Table(),
                                ServiceConfig(policy=policy), device=dev)
            before = gp_readout.launches
            svc.run()
            runs[str(dev)] = [dataclasses.astuple(t) for t in svc.trials]
            if str(dev) == "cuda":
                assert gp_readout.launches - before == len(svc.trials)
        assert runs["cuda"] == runs["cpu"]


def test_bench_time_us_waits_for_the_card(cuda):
    """``benchmarks.common.time_us`` waits for the card: with ``sync=True``
    after every call, so each call's time covers the kernel it enqueued;
    without, once after the loop.  Either way every kernel enqueued inside
    has finished when it returns."""
    from repro_torch.benchmarks.common import time_us, timed

    cycles = 20_000_000              # about 10 ms of a spinning kernel
    done = []

    def enqueue():
        torch.cuda._sleep(cycles)
        ev = torch.cuda.Event()
        ev.record()
        done.append(ev)

    enqueue()
    torch.cuda.synchronize()
    t = time.perf_counter()
    enqueue()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t
    for sync in (True, False):
        done.clear()
        us = time_us(enqueue, iters=4, warmup=1, sync=sync)
        assert len(done) == 5 and all(ev.query() for ev in done)
        assert us >= 0.5 * one_s * 1e6, (sync, us, one_s)
    done.clear()
    seconds, _ = timed(enqueue)
    assert done[0].query() and seconds >= 0.5 * one_s


def test_bench_section_on_card_equals_cpu(cuda, monkeypatch):
    """One smoke section (``stream``: kernels 1-3 through the streaming
    engine and the three scorers) gives the same rows on the card as on the
    CPU, less its host times."""
    from repro_torch.benchmarks import common, run, stream_churn

    monkeypatch.setattr(common, "FAST", True)
    counts = (ei_score.launches, ei_score.topk_launches, gp_readout.launches)
    card = run.comparable("stream", common.capture_rows(stream_churn.main, device=cuda))
    after = (ei_score.launches, ei_score.topk_launches, gp_readout.launches)
    cpu = run.comparable("stream", common.capture_rows(stream_churn.main, device="cpu"))
    assert card == cpu
    assert all(a > b for a, b in zip(after, counts)), (counts, after)
