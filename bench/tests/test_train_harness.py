"""The training cell's harness on the CPU at a tiny width (2 layers, d_model
64, vocabulary 256, S 64): the result line's schema and ``correct``, which
cells report which end-to-end metrics, the FLOP count and ``mfu_train`` on
hand-worked cases, the program against the plain reference at float32,
the reference's quadratic SSD against the recurrence, and ``correct``
coming out false for the bfloat16 control and for each planted fault.

Run from the root of the repository: ``python -m pytest bench/tests``.
"""

from __future__ import annotations

import io
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

from bench import run, train_check, train_faults, train_flops, train_inputs  # noqa: E402
from bench import train_reference  # noqa: E402

CELL = "mamba2-1.3b.train"
SWEEPS = ("fig5.mdmt", "dlzoo.mdmt", "fig5.baselines")
FULL = json.loads((ROOT / "bench" / "configs" / "mamba2-1.3b.json").read_text())
TINY = dict(FULL, name="tiny", d_model=64, n_layer=2, vocab_size=250,
            ssm_cfg=dict(FULL["ssm_cfg"], headdim=32, d_state=16, chunk_size=16))
TRAFFIC = {"batch": 1, "seq_len": 64, "zipf_a": 1.3, "checked_steps": 3}
#: the tiny cells: (config changes, limits); float32 compute is held to
#: float32 rounding, the bf16 cells to the full cell's limits
CELLS = {"tiny.train": ({}, None),
         "tiny.control": ({"param_dtype": "bfloat16", "moment_dtype": "bfloat16"}, None),
         "tiny.f32": ({"compute_dtype": "float32"},
                      {"loss_rel_err": 1e-5, "grad_norm_rel_err": 1e-5, "update_err": 1e-4})}
LIMITS = json.loads((ROOT / "bench" / "checks" / f"{CELL}.json").read_text())
SEED = 3_000_000_019


def make_root(base: Path) -> Path:
    """A checkout in ``base`` holding only BENCHMARK.json and bench/, with
    the tiny training cells added as files."""
    shutil.copytree(ROOT / "bench", base / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (base / "bench" / "traffic" / "tiny-train.json").write_text(json.dumps(TRAFFIC))
    for cell, (changes, limits) in CELLS.items():
        name = cell.replace(".", "-")
        (base / "bench" / "configs" / f"{name}.json").write_text(json.dumps(dict(TINY, **changes)))
        (base / "bench" / "checks" / f"{cell}.json").write_text(json.dumps(limits or LIMITS))
        bench["configs"].append({"name": name, "source": "tests", "why": "tests",
                                 "file": f"bench/configs/{name}.json", "reduced": []})
        bench["workloads"].append({"name": cell, "config": name, "traffic": "tiny-train",
                                   "chips": 1, "why": "tests"})
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if CELL in metric.get("workloads", ()):
                metric["workloads"].append(cell)
    (base / "BENCHMARK.json").write_text(json.dumps(bench))
    return base


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("checkout"))


def drive(root, cell="tiny.train", trace=0, seed=SEED, simulate=None):
    out, err = io.StringIO(), io.StringIO()
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0",
                   "--trace", str(trace)], root=root, device="cpu", simulate=simulate,
                  out=out, err=err)
    lines = out.getvalue().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def test_end_to_end_metrics_by_cell():
    names = lambda cell: [m["name"] for m in run.load_cell(ROOT, cell)["end_to_end"]]
    assert names(CELL) == ["tokens_per_s", "mfu_train", "peak_device_gb", "setup_s"]
    for cell in SWEEPS:
        assert names(cell) == ["episodes_per_s", "peak_device_gb", "setup_s"]
    per_layer = {m["name"] for m in run.load_cell(ROOT, CELL)["per_layer"]}
    assert per_layer == {"train_step_ms", "train_ops_per_step", "device_idle_share.train",
                         "matmul_time_share"}


def test_result_line_schema_and_correct(root):
    rc, line, err = drive(root)
    assert rc == 0
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] == 1
    # no card: no memory reading and no peak to take a share of
    assert set(line["metrics"]) == {"tokens_per_s", "setup_s"}
    assert line["metrics"]["tokens_per_s"]["unit"] == "tokens/s"
    assert list(line["checks"]) == [*train_check.NAMES, "steps_checked"]
    assert line["checks"]["steps_checked"] == {"value": 3, "limit": 3}
    assert err.strip().splitlines()[-1] == "check steps_checked 3 limit 3"


def test_traced_line_counts_the_backward(root, capsys):
    rc, line, _ = drive(root, trace=1)
    assert rc == 0 and line["correct"] is True
    # on the CPU there is no device trace: those readers find nothing
    assert set(line["metrics"]) == {"train_step_ms", "train_ops_per_step"}
    phases = capsys.readouterr().err
    backward = int(phases.split("of them backward formulas ")[1].split()[0])
    assert backward > 0 and line["metrics"]["train_ops_per_step"]["value"] > 2 * backward


def test_sweep_line_keeps_its_keys(tmp_path):
    from bench.tests import test_sweep_harness as sweep_tests
    rc, line, _ = sweep_tests.drive(sweep_tests.make_root(tmp_path), "tiny.zoo")
    assert rc == 0 and line["correct"] is True
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert list(line["checks"]) == ["trial_mismatches", "event_mismatches", "regret_err",
                                    "episodes_checked"]
    assert set(line["metrics"]) == {"episodes_per_s", "setup_s"}


def test_program_at_float32_matches_the_reference(root):
    rc, line, _ = drive(root, "tiny.f32")
    assert rc == 0 and line["correct"] is True
    assert all(line["checks"][k]["value"] < 1e-5 for k in train_check.NAMES)


def test_control_bfloat16_state_is_not_correct(root):
    rc, line, _ = drive(root, "tiny.control")
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["update_err"]["value"] > line["checks"]["update_err"]["limit"]


@pytest.mark.parametrize("fault", sorted(train_faults.FAULTS))
def test_faults_are_not_correct(root, fault):
    rc, line, err = drive(root, simulate=train_faults.FAULTS[fault])
    assert rc == 0 and line["correct"] is False, err


def test_inputs_reproducible_from_seed():
    a, b = (train_inputs.weights(TINY, SEED, "cpu") for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed.table"], train_inputs.weights(TINY, SEED + 1, "cpu")["embed.table"])
    rows = [train_inputs.rows(TINY, TRAFFIC, SEED, i, "cpu")["tokens"] for i in (2, 0, 2)]
    assert torch.equal(rows[0], rows[2]) and not torch.equal(rows[0], rows[1])
    assert int(rows[0].max()) < TINY["vocab_size"]


def test_reference_ssd_is_the_recurrence():
    g = torch.Generator().manual_seed(5)
    B, S, H, P, N = 1, 40, 3, 4, 5
    x, Bm, Cm = (torch.randn(s, generator=g, dtype=torch.float64)
                 for s in ((B, S, H, P), (B, S, N), (B, S, N)))
    dt = torch.rand((B, S, H), generator=g, dtype=torch.float64) * 0.1
    A = -torch.rand(H, generator=g, dtype=torch.float64) * 3
    h = torch.zeros(B, H, P, N, dtype=torch.float64)
    want = []
    for t in range(S):
        h = torch.exp(dt[:, t] * A)[..., None, None] * h + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], Bm[:, t], x[:, t])
        want.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], h))
    got = train_reference.ssd(x, dt, A, Bm, Cm)
    assert torch.allclose(got, torch.stack(want, 1), rtol=1e-12, atol=1e-12)


def test_flops_hand_worked():
    # d 64, d_inner 128, d_state 16, heads 4 x headdim 32, chunk 16, 2
    # layers, 256 embedding rows
    proj = 2 * 64 * 256 + 2 * 64 * 32 + 2 * 64 * 4 + 2 * 128 * 64
    ssd = 2 * 16 * 16 + 2 * 16 * 4 * 32 + 2 * (2 * 16 * 4 * 32)
    assert (proj, ssd) == (53_760, 12_800)
    assert train_flops.per_token(TINY) == 3 * (2 * (proj + ssd) + 2 * 64 * 256) == 497_664


def test_mfu_reads_the_bf16_peak():
    from bench import load_module
    mfu = load_module(ROOT / "bench" / "metrics" / "mfu_train.py", "mfu_train")
    ctx = {"device_kind": "NVIDIA H100 80GB HBM3", "compute_dtype": "bfloat16",
           "flops_per_token": 8.8e9, "window": {"tokens": 4096 * 20, "elapsed_s": 55.0}}
    assert mfu.read(ctx) == pytest.approx(100 * 4096 * 20 / 55.0 * 8.8e9 / 989e12)
    assert mfu.read(dict(ctx, device_kind="cpu")) is None
    assert mfu.read(dict(ctx, compute_dtype="float32")) is None
