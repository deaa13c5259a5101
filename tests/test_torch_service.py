"""The port's real-executor AutoML service against the reference's, on the
CPU.

Every case of ``tests/test_service.py`` runs on the port with the same
``FakeExecutor`` (a z table and a fixed duration), and the same service on
the reference beside it: the trial sequences (model, tenant, arch, slice,
start, end, z) are equal trial for trial, for all three policies, through
crash and restore.  Both services are handed one cost model: each
package's ``CostModel`` on the reference's hardware table (test data only;
the port's default is the H100's, whose c(x) and so mdmt's picks differ).
One ``RealExecutor`` trial each for olmo-1b and mamba2-1.3b trains from
the reference's own initial parameters in float32; its z is held to the
reference's to rtol 1e-5 (ten AdamW steps and two evaluation losses, the
gradients agreeing to 2e-6 of each leaf's largest value).
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import repro.core.service as J  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import cost_model as j_cm  # noqa: E402
from repro.core.fleet import Fleet as JFleet  # noqa: E402
from repro.launch import hlo_analysis  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
import repro_torch.core.service as T  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core import cost_model as t_cm  # noqa: E402
from repro_torch.core.fleet import Fleet as TFleet  # noqa: E402
from repro_torch.kernels import gp_readout  # noqa: E402

Z_RTOL = 1e-5
ARCHS = ["olmo-1b", "qwen3-4b", "mamba2-1.3b"]
POLICIES = ["mdmt", "round_robin", "random"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the suite runs several test files at once on the
    CPU's cores, where more threads a process only oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class FakeExecutor:
    """Deterministic z-table + constant durations; counts invocations."""

    def __init__(self, z_table, seconds=1.0):
        self.z = z_table        # dict (tenant_id, arch) -> z
        self.seconds = seconds
        self.calls = []

    def run(self, tenant, arch):
        self.calls.append((tenant.tenant_id, arch))
        return self.z[(tenant.tenant_id, arch)], self.seconds


class CrashingExecutor(FakeExecutor):
    """Raises on the Nth trial launch: a coordinator dying with trials in
    flight (the checkpoint then holds selected-but-unobserved models)."""

    def __init__(self, z_table, crash_at, seconds=1.0):
        super().__init__(z_table, seconds)
        self.crash_at = crash_at

    def run(self, tenant, arch):
        if len(self.calls) + 1 >= self.crash_at:
            raise RuntimeError("coordinator crash")
        return super().run(tenant, arch)


@pytest.fixture(autouse=True)
def shared_cost_model(tmp_path, monkeypatch):
    """Both cost models on the reference's hardware table and an empty
    probe directory (the analytic path), so c(x) is the same in both."""
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(t_cm, name, getattr(hlo_analysis, name))
    monkeypatch.setattr(t_cm, "DRYRUN_DIR", tmp_path / "dryrun")
    monkeypatch.setattr(j_cm, "DRYRUN_DIR", tmp_path / "dryrun")


def _z_table(tenants):
    return {(t.tenant_id, a): 0.3 + 0.1 * ((t.tenant_id + j) % 3)
            for t in tenants for j, a in enumerate(ARCHS)}


def make_service(pkg, tmp_path=None, policy="mdmt", num_slices=2, executor=None,
                 ckpt_name="svc.json"):
    """``test_service.py``'s service on one package (J or T)."""
    tenants = [pkg.TenantSpec(i, i, 1.2) for i in range(3)]
    z = _z_table(tenants)
    ex = executor or FakeExecutor(z)
    fleet = (JFleet if pkg is J else TFleet).partition_pod(256, num_slices)
    kw = {} if pkg is J else {"device": "cpu"}
    service = pkg.AutoMLService(
        tenants, ARCHS, fleet, ex, pkg.ServiceConfig(policy=policy),
        checkpoint_path=str(tmp_path / ckpt_name) if tmp_path else None, **kw)
    return service, ex, z


def _trials(service):
    return [dataclasses.astuple(t) for t in service.trials]


@pytest.mark.parametrize("policy", POLICIES)
def test_service_observes_all_models(policy):
    service, ex, z = make_service(T, policy=policy)
    trials = service.run()
    assert len(trials) == 9
    assert len(set((t.tenant, t.arch) for t in trials)) == 9
    for i in range(3):
        want = max(z[(i, a)] for a in ARCHS)
        assert service.best[i] == pytest.approx(want)
    ref, ref_ex, _ = make_service(J, policy=policy)
    ref.run()
    assert _trials(service) == _trials(ref)
    assert ex.calls == ref_ex.calls
    np.testing.assert_array_equal(service.best, ref.best)
    np.testing.assert_array_equal(service.cost, ref.cost)


@pytest.mark.parametrize("policy", POLICIES)
def test_service_checkpoint_requeues_inflight(tmp_path, policy):
    out = {}
    for pkg in (J, T):
        service, _, _ = make_service(pkg, tmp_path, policy=policy,
                                     ckpt_name=f"{pkg.__name__}.json")
        service.run(max_trials=4)
        # simulate a crash: build a fresh service, restore
        service2, _, _ = make_service(pkg, tmp_path, policy=policy,
                                      ckpt_name=f"{pkg.__name__}.json")
        assert service2.restore()
        assert len(service2.gp.observed) >= 3
        # anything selected-but-unobserved must have been requeued
        assert service2.selected.sum() == len(service2.gp.observed)
        service2.run()
        assert service2.selected.all()
        out[pkg] = (_trials(service), list(service2.gp.observed), _trials(service2))
    assert out[T] == out[J]
    # the two packages write the same checkpoint
    assert (tmp_path / f"{T.__name__}.json").read_text() == \
        (tmp_path / f"{J.__name__}.json").read_text()


def test_service_cost_model_updates_from_measured():
    service, ex, _ = make_service(T)
    before = dict(service.cost_model._measured)
    service.run(max_trials=2)
    assert len(service.cost_model._measured) > len(before)
    ref, _, _ = make_service(J)
    ref.run(max_trials=2)
    assert service.cost_model._measured == ref.cost_model._measured


@pytest.mark.parametrize("policy", POLICIES)
def test_service_crash_mid_episode_restores_and_replays(tmp_path, policy):
    """Kill the coordinator mid-episode, restart from the JSON checkpoint:
    in-flight trials are re-queued and, under mdmt, the combined trial
    sequence matches an uninterrupted run exactly; under every policy both
    packages run the same trials, and the port also restores from the
    reference's checkpoint."""
    out = {}
    for pkg in (J, T):
        service0, _, _ = make_service(pkg, policy=policy)
        service0.run()
        uninterrupted = [t.model for t in service0.trials]

        # crash while trial #3 is still in flight (2 completed, 1 launched)
        ck = f"{pkg.__name__}.json"
        z = _z_table([pkg.TenantSpec(i, i, 1.2) for i in range(3)])
        crashed, _, _ = make_service(pkg, tmp_path, policy=policy, ckpt_name=ck,
                                     executor=CrashingExecutor(z, crash_at=4))
        with pytest.raises(RuntimeError):
            crashed.run()
        at_crash = (tmp_path / ck).read_text()
        (tmp_path / f"crash_{ck}").write_text(at_crash)
        state = json.loads(at_crash)
        completed = [int(k) for k in state["observations"]]
        assert sum(state["selected"]) > len(completed), "crash left trials in flight"

        restored, _, _ = make_service(pkg, tmp_path, policy=policy, ckpt_name=ck)
        assert restored.restore()
        assert int(restored.selected.sum()) == len(restored.gp.observed) == len(completed)
        restored.run()
        combined = completed + [t.model for t in restored.trials]
        if policy == "mdmt":   # round_robin's pointer, random's draws restart
            assert combined == uninterrupted
        assert sorted(combined) == list(range(restored.n))
        out[pkg] = (uninterrupted, completed, _trials(restored))
    assert out[T] == out[J]
    # the port's coordinator picks up the reference's checkpoint
    port, _, _ = make_service(T, tmp_path, policy=policy,
                              ckpt_name=f"crash_{J.__name__}.json")
    assert port.restore()
    port.run()
    assert _trials(port) == out[J][2]


def test_restore_without_checkpoint():
    service, _, _ = make_service(T)
    assert service.restore() is False


def test_decisions_read_the_posterior_through_the_readout():
    """Every decision reads the posterior once, through ``ops.gp_readout``
    (kernel 1 on the card); on the CPU no kernel launches."""
    service, _, _ = make_service(T)
    reads = []
    readout = service.gp._readout

    def counted(emit_sd):
        reads.append(emit_sd)
        return readout(emit_sd)

    service.gp._readout = counted
    before = gp_readout.launches
    service.run()
    assert reads == [True] * len(service.trials)
    assert gp_readout.launches == before


def test_estimate_prior_matches_reference():
    prior = [J.TenantSpec(100, 100, 1.1), J.TenantSpec(101, 101, 1.7)]
    z = {(t.tenant_id, a): 0.2 + 0.05 * j + 0.01 * t.tenant_id
         for t in prior for j, a in enumerate(ARCHS)}
    mu, K = T.estimate_prior(ARCHS, [T.TenantSpec(*dataclasses.astuple(t)) for t in prior],
                             FakeExecutor(z))
    jmu, jK = J.estimate_prior(ARCHS, prior, FakeExecutor(z))
    np.testing.assert_array_equal(mu, jmu)
    np.testing.assert_array_equal(K, jK)
    # with a prior, both services build the same GP prior and pick alike
    port = T.AutoMLService([T.TenantSpec(i, i, 1.2) for i in range(2)], ARCHS,
                           TFleet.partition_pod(256, 2), FakeExecutor(_z_table(
                               [T.TenantSpec(i, i, 1.2) for i in range(2)])),
                           prior=(mu, K), device="cpu")
    ref = J.AutoMLService([J.TenantSpec(i, i, 1.2) for i in range(2)], ARCHS,
                          JFleet.partition_pod(256, 2), FakeExecutor(_z_table(
                              [J.TenantSpec(i, i, 1.2) for i in range(2)])),
                          prior=(jmu, jK))
    port.run()
    ref.run()
    assert _trials(port) == _trials(ref)


def test_entry_points_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.RealExecutor(T.ServiceConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.AutoMLService([T.TenantSpec(0, 0, 1.2)], ARCHS, TFleet.partition_pod(256, 2),
                        FakeExecutor({}))


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype=cfg.param_dtype)


def test_real_executor_trial_matches_reference(monkeypatch):
    """One trial each for olmo-1b and mamba2-1.3b in float32 (both
    packages' smoke configs patched to float32 compute), from the
    reference's initial parameters: z equal to the reference's."""
    monkeypatch.setattr(J, "get_smoke_config", lambda a: _f32(j_smoke(a)))
    monkeypatch.setattr(T, "get_smoke_config", lambda a: _f32(t_smoke(a)))
    jcfgs = {}

    def reference_init(cfg, seed):
        jcfg = jcfgs[cfg.name]
        assert convert.model_config({f.name: getattr(jcfg, f.name)
                                     for f in dataclasses.fields(jcfg)}) == cfg
        params = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
        return convert.model_params(jax.tree.map(np.asarray, params), "cpu")

    svc = dict(steps_per_trial=10, eval_steps=2, seq_len=64, batch=4)
    port = T.RealExecutor(T.ServiceConfig(**svc), device="cpu", init=reference_init)
    ref = J.RealExecutor(J.ServiceConfig(**svc))
    for arch, tenant in (("olmo-1b", (0, 7, 1.25)), ("mamba2-1.3b", (1, 3, 1.5))):
        jcfgs[f"{arch}-smoke"] = _f32(j_smoke(arch))
        z, wall = port.run(T.TenantSpec(*tenant), arch)
        want, _ = ref.run(J.TenantSpec(*tenant), arch)
        assert 0.0 < z <= 1.0 and wall > 0.0
        np.testing.assert_allclose(z, want, rtol=Z_RTOL)


def test_example_protocol_on_fake_trials():
    """The port's example (``repro_torch.examples.multi_tenant_service``):
    a prior from 8 trainings, 5 trials, a crash, a restore and the run to
    its end observe each of the 12 models once."""
    from repro_torch.examples import multi_tenant_service as example

    z = {(t.tenant_id, a): 0.01 * (1 + t.tenant_id + j)
         for t in example.PRIOR_TENANTS + example.TENANTS
         for j, a in enumerate(example.ARCHS)}
    ex = FakeExecutor(z)
    (mu, K), first, restored = example.run(ex, device="cpu")
    assert len(ex.calls) == 8 + 12 and mu.shape == (4,) and K.shape == (4, 4)
    assert len(first.trials) == example.CRASH_AFTER
    models = [t.model for t in first.trials + restored.trials]
    assert sorted(models) == list(range(12)) and restored.selected.all()
