"""The harness on the CPU at a tiny size: a cell found from its files alone,
traffic reproducible from the seed, the result line's schema, the byte
count on a hand-worked case, and ``correct`` coming out false for the
control and for each fault the sweep cells can have.

Run from the root of the repository: ``python -m pytest bench/tests``.
"""

from __future__ import annotations

import dataclasses
import io
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

from bench import reference, run, sweep_bytes  # noqa: E402
from bench.systems import sweep  # noqa: E402

TINY_FIG5 = {"system": "sweep", "generator": "matern_blocks", "num_users": 6,
             "num_models_per_user": 7, "length_scale": 0.2, "kernel_variance": 0.04,
             "cost": "uniform", "warm_start": 2, "jitter": 1e-6}
TINY_ZOO = {"system": "sweep", "generator": "ease_ml_zoo", "models": list("abcdefgh"),
            "num_prior_users": 8, "num_test_users": 5, "acc_std": 0.04,
            "base_accuracy": [0.6, 0.92], "cost_range": [600.0, 21600.0],
            "size_factor": [0.5, 2.0], "clip": [0.02, 0.995], "warm_start": 2, "jitter": 1e-6}
TRAFFIC = {"tiny_all": {"policies": ["mdmt", "round_robin", "random"],
                        "device_counts": [1, 2, 5], "draws": 2, "check_episodes": 6}}
#: the tiny cells are held to the Fig. 5 cell's limits
LIMITS = json.loads((ROOT / "bench" / "checks" / "fig5.mdmt.json").read_text())
SEED = 3_000_000_017


def make_root(base: Path) -> Path:
    """A checkout in ``base`` holding only BENCHMARK.json and bench/, with
    tiny cells added as files."""
    shutil.copytree(ROOT / "bench", base / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, cfg in (("tiny-fig5", TINY_FIG5), ("tiny-zoo", TINY_ZOO)):
        (base / "bench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "tests", "why": "tests",
                                 "file": f"bench/configs/{name}.json", "reduced": []})
    for name, mix in TRAFFIC.items():
        (base / "bench" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for cell, cfg in (("tiny.fig5", "tiny-fig5"), ("tiny.zoo", "tiny-zoo")):
        (base / "bench" / "checks" / f"{cell}.json").write_text(json.dumps(LIMITS))
        bench["workloads"].append({"name": cell, "config": cfg, "traffic": "tiny_all",
                                   "chips": 1, "why": "tests"})
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if "fig5.mdmt" in metric.get("workloads", ()):
                metric["workloads"].append(cell)
    (base / "BENCHMARK.json").write_text(json.dumps(bench))
    return base


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("checkout"))


def drive(root, cell="tiny.fig5", trace=0, seed=SEED, simulate=None, seconds=0.0):
    out, err = io.StringIO(), io.StringIO()
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], root=root, device="cpu", simulate=simulate,
                  out=out, err=err)
    lines = out.getvalue().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def test_cell_found_from_its_files(root):
    cell = run.load_cell(root, "tiny.zoo")
    assert cell["config"]["num_test_users"] == 5
    assert cell["traffic"]["device_counts"] == [1, 2, 5]
    assert [m["name"] for m in cell["end_to_end"]] == ["episodes_per_s", "peak_device_gb", "setup_s"]
    assert {m["name"] for m in cell["per_layer"]} >= {"loop_step_ms", "ops_per_step"}


@pytest.mark.parametrize("cell", ["tiny.fig5", "tiny.zoo"])
def test_result_line_schema_and_correct(root, cell):
    rc, line, err = drive(root, cell)
    assert rc == 0
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == 3 * 3 * 2
    assert set(line["metrics"]) == {"episodes_per_s", "setup_s"}  # no card: no memory reading
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["checks"]["episodes_checked"] == {"value": 6, "limit": 6}
    assert err.strip().splitlines()[-1].startswith("check episodes_checked 6 limit 6")


def test_traced_line_has_counts(root):
    rc, line, _ = drive(root, "tiny.fig5", trace=1)
    assert rc == 0 and line["correct"] is True
    # on the CPU there is no device trace: those readers find nothing
    assert set(line["metrics"]) == {"host_outside_loop_s", "loop_step_ms", "ops_per_step"}
    assert line["metrics"]["ops_per_step"]["unit"] == "ops/step"


def test_traffic_reproducible_from_seed(root):
    cell = run.load_cell(root, "tiny.zoo")
    from bench.generators import ease_ml_zoo
    a, b = (sweep.episodes(cell["traffic"], SEED) for _ in range(2))
    assert a == b and a != sweep.episodes(cell["traffic"], SEED + 1)
    za = ease_ml_zoo.draw_truth(TINY_ZOO, ease_ml_zoo.build(TINY_ZOO, SEED), 2, SEED, "cpu")
    zb = ease_ml_zoo.draw_truth(TINY_ZOO, ease_ml_zoo.build(TINY_ZOO, SEED), 2, SEED, "cpu")
    assert np.array_equal(za, zb)
    assert sweep.checked_episodes(18, 6, SEED) == sweep.checked_episodes(18, 6, SEED)


def test_no_card_no_result(root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    rc = run.main(["--workload", "tiny.fig5", "--seed", "1", "--seconds", "1"],
                  root=root, out=out, err=err)
    assert rc != 0 and out.getvalue() == ""


def test_byte_count_hand_worked():
    # 2 tenants x 3 models (n 6), 2 episodes, T 4 steps; 5 folds; hints:
    # episode 0 mdmt (2 warm, 4 EIrate picks), episode 1 per-tenant (2 warm,
    # 3 picks, one slot unlaunched)
    obs = np.array([[-1, 0, 3, 4], [2, -1, 5, -1]])
    hints = np.array([[-2, -2, -1, -1, -1, -1], [-2, -2, 0, 1, 1, -2]])
    fold = 2 * 9 * 4 + 3 * 4 + 3 * 4 + 3 * 3 * 4        # P r/w, K row, mu0, 3 outputs
    eirate = 6 * 4 + 6                                   # EI + launched flags
    tenant = 6 + 3 * 4                                   # flags + the tenant's EI
    want = 5 * fold + 4 * eirate + 3 * tenant + 4 * 6 * 4
    assert fold == 132 and want == 5 * 132 + 4 * 30 + 3 * 18 + 96
    assert sweep_bytes.call_bytes(2, 3, 4, obs, hints) == want


class _Event:
    def __init__(self, name, device, start, duration):
        self._v = name, device, start, duration

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]


def _events(kernels_kept):
    host, card = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ev = []
    for i in range(10_001):                # 10,001 launches, 100 ns apart
        ev.append(_Event("cudaLaunchKernel", host, 1_000 + 100 * i, 10))
        if i < kernels_kept:
            ev.append(_Event("k", card, 1_050 + 100 * i, 20))
    ev.append(_Event("Memcpy DtoH (Device -> Pageable)", card, 2_000_000, 500_000))
    ev.append(_Event("cudaMemcpyAsync", host, 1_001_100, 1_499_000))   # waits for the copy
    return ev


def test_trace_summary_and_dropped_records(monkeypatch):
    from bench import devtrace
    s = devtrace.summarize(_events(10_001), 3e-3, "sweep_call")
    assert s["kernels"] == s["launches"] == 10_001 and s["records"] == 10_002
    assert s["busy_s"] == pytest.approx((10_001 * 20 + 500_000) / 1e9)
    assert s["kernel_s"] == pytest.approx(10_001 * 20 / 1e9)
    gaps = s["breakdown"]["idle_gaps"]
    assert gaps[0][0].startswith("cudaMemcpyAsync") and gaps[0][1] == pytest.approx(
        (2_000_000 - 1_050 - 100 * 10_000 - 20) / 1e9)
    assert devtrace.summarize(_events(9_999), 3e-3, "sweep_call")["records"] == 10_000

    def traced(*kept):
        """profile_agreed over calls whose traces keep ``kept`` kernels."""
        summaries = iter(devtrace.summarize(_events(k), 3e-3, "sweep_call") for k in kept)
        monkeypatch.setattr(devtrace, "profile_call", lambda fn, span: (fn(), next(summaries)))
        return devtrace.profile_agreed(lambda: "out")

    assert traced(10_001, 10_001)[2] == [10_002, 10_002]
    # a call whose trace lost records is not read, whichever call lost them
    out, summary, seen = traced(10_001, 10_000, 10_001)
    assert out == "out" and summary["kernels"] == 10_001 and seen == [10_002, 10_001, 10_002]
    assert traced(9_990, 10_001, 10_001)[2] == [9_991, 10_002, 10_002]
    # two traces that lost the same number of kernels (launches kept) do not agree
    with pytest.raises(devtrace.DroppedRecords):
        traced(10_000, 10_000, 9_999)
    with pytest.raises(devtrace.DroppedRecords):
        traced(10_001, 10_000, 9_999)


def _reference_in_place(precision):
    """The reference, in ``precision``, put in the program's place."""
    from repro_torch.core.sim_batched import BatchResult

    from bench.control import as_rows

    def simulate(problem, specs, warm_start, jitter, *, device):
        T = problem.num_models + max(s.num_devices for s in specs)
        inputs = {"K": problem.K, "mu0": problem.mu0, "cost": problem.cost,
                  "membership": problem.membership}
        rows = [as_rows(reference.run_episode(inputs, s.policy, s.num_devices, s.seed,
                                              s.z_true, warm_start, jitter, T, precision))
                for s in specs]
        stack = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
        return BatchResult(problem=problem, specs=tuple(specs), warm_start=warm_start,
                           **{f"trial_{f}": stack[f] for f in ("model", "user", "device",
                                                                "start", "end")},
                           trial_z=None, obs_model=stack["obs_model"],
                           obs_time=stack["obs_time"], inst_regret=stack["inst_regret"],
                           cum_regret=stack["cum_regret"], decisions=stack["decisions"],
                           end_time=stack["end_time"])
    return simulate


def test_reference_in_float32_in_place_is_correct(root):
    rc, line, _ = drive(root, simulate=_reference_in_place("float32"))
    assert rc == 0 and line["correct"] is True


def test_control_bfloat16_is_not_correct(root):
    rc, line, _ = drive(root, simulate=_reference_in_place("bfloat16"))
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["trial_mismatches"]["value"] > 0


def _program():
    from repro_torch.core.sim_batched import simulate_batch
    return simulate_batch


class _DropStateWrites(torch.utils._python_dispatch.TorchDispatchMode):
    """Every in-place indexed write (``x[idx] = v``) is skipped: each step
    leaves the loop's state as it found it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.index_put_.default:
            return args[0]
        return func(*args, **(kwargs or {}))


def fault_state_unchanged(problem, specs, *a, **kw):
    with _DropStateWrites():
        return _program()(problem, specs, *a, **kw)


def fault_half_batch(problem, specs, *a, **kw):
    """Only the first half of the batch is run; its rows stand in for the
    rest."""
    half = _program()(problem, specs[:len(specs) // 2 + 1], *a, **kw)
    idx = np.arange(len(specs)) % (len(specs) // 2 + 1)
    take = {f.name: getattr(half, f.name)[idx] for f in dataclasses.fields(half)
            if isinstance(getattr(half, f.name), np.ndarray)}
    return dataclasses.replace(half, specs=tuple(specs), **take)


def fault_answer_altered(problem, specs, *a, **kw):
    """One launch of every episode goes to the next model in line."""
    res = _program()(problem, specs, *a, **kw)
    res.trial_model[:, -3] = (res.trial_model[:, -3] + 1) % res.trial_model.shape[1]
    return res


def fault_regret_altered(problem, specs, *a, **kw):
    """The instantaneous regret read 1% high at one step."""
    res = _program()(problem, specs, *a, **kw)
    res.inst_regret[:, 5] *= np.float32(1.01)
    return res


@pytest.mark.parametrize("fault", [fault_state_unchanged, fault_half_batch,
                                   fault_answer_altered, fault_regret_altered])
def test_faults_are_not_correct(root, fault):
    rc, line, err = drive(root, simulate=fault)
    assert rc == 0 and line["correct"] is False, err


def test_program_is_correct_on_the_tiny_cell(root):
    rc, line, _ = drive(root, simulate=_program())
    assert rc == 0 and line["correct"] is True
