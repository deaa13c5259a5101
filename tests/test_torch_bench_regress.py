"""The port's ``regress`` and its benchmark CLI, on the CPU.

``repro_torch.benchmarks.regress`` is a copy of the JAX package's
``benchmarks/regress.py`` (it reads JSON only).  Each case runs both on
the same payloads and directories (the cases of ``tests/test_capacity.py``'s
perf-regression plane) and holds the port's verdicts, ratios, reports,
history lines and return codes equal to the reference's.  Written out by
hand are only what the port adds: the card's power limit in the
environment match, and ``main`` reading ``BENCH_torch_*.json`` alone.
Then ``repro_torch.benchmarks.run``: its strict parsing, ``roofline``
emitting ``roofline_missing`` without a dry run, the CLI failing without a
card, and one
section's payload written and compared.
"""

import json
import sys

import pytest

torch = pytest.importorskip("torch")

from benchmarks import regress as j_regress  # noqa: E402  (repo root on sys.path)
from repro_torch.benchmarks import common, regress  # noqa: E402
from repro_torch.benchmarks import obs_overhead  # noqa: E402
from repro_torch.benchmarks import run as t_run  # noqa: E402

ENV = {"platform": "linux", "machine": "x86_64", "device_kind": "cpu",
       "device_count": 8, "fast": False}


def _payload(rows: dict, env=ENV, suite="demo",
             schema=common.BENCH_SCHEMA_VERSION):
    return {"schema_version": schema, "suite": suite, "git_sha": "deadbeef",
            "environment": dict(env) if env is not None else None,
            "rows": {k: {"us_per_call": float(v)} for k, v in rows.items()}}


def _compare(base, fresh, min_us=1000.0, allow_legacy=False):
    """The port's verdict, held equal to the reference's on the same
    payloads."""
    kw = dict(threshold=1.5, min_us=min_us, allow_legacy=allow_legacy)
    got = regress.compare_suites(base, fresh, **kw)
    assert got == j_regress.compare_suites(base, fresh, **kw)
    return got


# (baseline rows, fresh rows, min_us): test_capacity.py's cases, and the
# two edges of the noise rule (ratio = threshold, delta = min_us)
ROW_CASES = {
    "ratio_at_threshold": ({"edge": 10_000.0}, {"edge": 15_000.0}, 1000.0),
    "delta_at_min_us": ({"edge": 1_000.0}, {"edge": 2_000.0}, 1000.0),
    "2x_regression": ({"hot": 10_000.0, "cold": 400.0},
                      {"hot": 20_000.0, "cold": 400.0}, 1000.0),
    "jitter_under_floor": ({"tiny": 3.0}, {"tiny": 9.0}, 1000.0),
    "under_ratio": ({"slow": 10_000.0}, {"slow": 12_000.0}, 1000.0),
    "row_set_drift": ({"gone": 1.0, "kept": 1.0}, {"kept": 1.0, "born": 1.0},
                      1.0),
}


@pytest.mark.parametrize("case", list(ROW_CASES))
def test_regress_rows(case):
    base, fresh, min_us = ROW_CASES[case]
    _compare(_payload(base), _payload(fresh), min_us=min_us)


@pytest.mark.parametrize("base_kw, fresh_env", [
    ({}, dict(ENV, device_count=1)),
    ({}, dict(ENV, device_kind="NVIDIA H100 80GB HBM3")),
    ({"schema": 0}, ENV),
], ids=["device_count", "device_kind", "schema_version"])
def test_regress_refuses_cross_environment_and_cross_schema(base_kw, fresh_env):
    _compare(_payload({"a": 1.0}, **base_kw),
             _payload({"a": 9_999.0}, env=fresh_env), min_us=1.0)


def test_regress_refuses_another_power_limit():
    """The port's one added match field: a card set below its maximum runs
    slower, so runs under two power limits are not compared."""
    base = _payload({"a": 1.0}, env=dict(ENV, power_limit="700.00 W"))
    fresh = _payload({"a": 9_999.0}, env=dict(ENV, power_limit="500.00 W"))
    kw = dict(threshold=1.5, min_us=1.0, allow_legacy=False)
    v = regress.compare_suites(base, fresh, **kw)
    assert v["status"] == "skipped" and "power_limit" in v["reason"]
    assert j_regress.compare_suites(base, fresh, **kw)["status"] == "regression"


@pytest.mark.parametrize("allow_legacy", [False, True])
def test_regress_legacy_baseline(allow_legacy):
    _compare(_payload({"a": 100.0}, env=None), _payload({"a": 100.0}),
             min_us=1.0, allow_legacy=allow_legacy)


def _main_both(tmp_path, args):
    """rc, report and history lines of both ``main``s on the same
    directories, each with its own report and history file; the port's
    are returned once they equal the reference's.  The reference's
    "no committed baseline" reason is the port's "no baseline"."""
    out = []
    for tag, mod in (("port", regress), ("ref", j_regress)):
        report, history = tmp_path / f"{tag}_report.json", tmp_path / f"{tag}_history.jsonl"
        rc = mod.main(args + ["--report", str(report), "--history", str(history)])
        rep = json.loads(report.read_text()) if report.exists() else None
        hist = ([json.loads(line) for line in history.read_text().splitlines()]
                if history.exists() else [])
        report.unlink(missing_ok=True)
        history.unlink(missing_ok=True)
        out.append((rc, rep, hist))
    (rc, rep, hist), (j_rc, j_rep, j_hist) = out
    if j_rep is not None:
        for suite in j_rep["suites"]:
            if suite.get("reason") == "no committed baseline":
                suite["reason"] = "no baseline"
    assert (rc, rep, hist) == (j_rc, j_rep, j_hist)
    return rc, rep, hist


@pytest.mark.parametrize("case", ["regression", "identical", "no_baseline",
                                  "no_baseline_strict", "empty"])
def test_regress_cli_matches_the_reference(tmp_path, case):
    base_dir, fresh_dir = tmp_path / "base", tmp_path / "fresh"
    base_dir.mkdir(), fresh_dir.mkdir()
    name = "BENCH_torch_demo.json"
    (base_dir / name).write_text(json.dumps(_payload({"hot": 10_000.0})))
    fresh = 30_000.0 if case == "regression" else 10_000.0
    (fresh_dir / name).write_text(json.dumps(_payload({"hot": fresh})))
    if case.startswith("no_baseline"):
        (fresh_dir / "BENCH_torch_new.json").write_text(
            json.dumps(_payload({"x": 1.0}, suite="new")))
    if case == "empty":
        fresh_dir = tmp_path / "empty"
        fresh_dir.mkdir()
    args = ["--check", "--baseline-dir", str(base_dir), "--fresh-dir", str(fresh_dir)]
    if case == "no_baseline_strict":
        args.append("--strict")
    rc, rep, hist = _main_both(tmp_path, args)
    assert rc == {"regression": 1, "identical": 0, "no_baseline": 0,
                  "no_baseline_strict": 1, "empty": 2}[case]


def test_regress_cli_reads_the_ports_suites_alone(tmp_path):
    """The port's ``main`` reads ``BENCH_torch_*.json`` alone: the JAX
    package's suites in the same directory are not the port's."""
    base_dir, fresh_dir = tmp_path / "base", tmp_path / "fresh"
    base_dir.mkdir(), fresh_dir.mkdir()
    name = "BENCH_torch_demo.json"
    (base_dir / name).write_text(json.dumps(_payload({"hot": 10_000.0})))
    (fresh_dir / name).write_text(json.dumps(_payload({"hot": 30_000.0})))
    (fresh_dir / "BENCH_demo.json").write_text(json.dumps(_payload({"hot": 1.0})))
    report = tmp_path / "regress_report.json"
    rc = regress.main(["--check", "--baseline-dir", str(base_dir),
                       "--fresh-dir", str(fresh_dir), "--report", str(report)])
    assert rc == 1
    assert [s["suite"] for s in json.loads(report.read_text())["suites"]] == ["demo"]
    only_jax = tmp_path / "only_jax"
    only_jax.mkdir()
    (only_jax / "BENCH_demo.json").write_text(json.dumps(_payload({"hot": 1.0})))
    assert regress.main(["--check", "--fresh-dir", str(only_jax),
                         "--report", str(report)]) == 2


def test_section_payload_and_regress_on_it(tmp_path, monkeypatch, capsys):
    """One new section's BENCH_torch_<suite>.json (schema 1, the
    environment stamp), then regress on it as chip_smoke.py's suites phase
    does on the card's: itself flags nothing, a doubled row is flagged,
    another device kind is an environment mismatch."""
    monkeypatch.setattr(common, "FAST", True)
    common.begin_suite(t_run.SUITE_NAMES["obs"])
    obs_overhead.main(device="cpu")
    path = common.end_suite(tmp_path)
    capsys.readouterr()
    assert path.name == "BENCH_torch_obs_overhead.json"
    payload = json.loads(path.read_text())
    assert payload["schema_version"] == common.BENCH_SCHEMA_VERSION == 1
    assert payload["environment"]["fast"] is True
    if not torch.cuda.is_available():
        assert payload["environment"]["device_kind"] == "none"
    # min_us 1: a row that rounds to 0.0 us is not a regression of itself
    same = _compare(payload, payload, min_us=1.0)
    assert same["status"] == "ok"
    assert {r["status"] for r in same["rows"]} == {"ok"}
    slowest = max(payload["rows"], key=lambda n: payload["rows"][n]["us_per_call"])
    doubled = json.loads(path.read_text())
    doubled["rows"][slowest]["us_per_call"] *= 2
    v = _compare(payload, doubled, min_us=1.0)
    assert v["status"] == "regression"
    assert [r["name"] for r in v["rows"] if r["status"] == "regression"] == [slowest]
    other = json.loads(path.read_text())
    other["environment"]["device_kind"] = "another card"
    v = _compare(payload, other, min_us=1.0)
    assert v["status"] == "skipped" and "device_kind" in v["reason"]


@pytest.mark.parametrize("argv", [
    ["bogus"], ["control", "--bogus"], ["--seeds", "0"], ["--engine", "scan"]])
def test_run_parses_strictly(argv, capsys):
    with pytest.raises(SystemExit):
        t_run._parse_args(argv)


def test_run_lists_every_section(capsys):
    assert t_run.SECTIONS == (
        "fig2", "fig3", "fig4", "fig5", "control", "stream", "shard",
        "devchurn", "eventlog", "dtrace", "obs", "capacity", "chaos",
        "roofline")
    assert t_run.SUITE_NAMES["control"] == "torch_control_plane"
    assert t_run.SUITE_NAMES["stream"] == "torch_stream_churn"
    assert t_run.SUITE_NAMES["fig5"] == "torch_fig5"
    assert set(t_run.HOST_TIME_KEYS) == set(t_run.MODULES) - {"fig2", "fig3", "fig4", "fig5"}
    args = t_run._parse_args(["shard", "chaos", "--smoke"])
    assert (args.sections, args.smoke) == (["shard", "chaos"], True)
    with pytest.raises(SystemExit):
        t_run._parse_args(["--help"])
    helptext = capsys.readouterr().out
    for section in t_run.SECTIONS:
        assert f"\n  {section} " in helptext


def test_roofline_raises(tmp_path, monkeypatch, capsys):
    """The roofline section, once a stub that raised, reads the port's dry
    run: with no probe record it emits ``roofline_missing``, as the JAX
    package's does, and needs no card."""
    from repro_torch.core import cost_model as t_cm

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(t_cm, "DRYRUN_DIR", tmp_path / "dryrun_torch")
    monkeypatch.setattr(sys, "argv", ["run", "roofline"])
    t_run.main()
    assert "roofline_missing,0.0,note=" in capsys.readouterr().out
    assert [p.name for p in tmp_path.glob("BENCH_*.json")] == ["BENCH_torch_roofline.json"]


def test_cli_needs_a_card(tmp_path, monkeypatch, capsys):
    """The CLI runs on the card; without one every section fails and no
    BENCH file is written."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would run the sections")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(common, "FAST", True)
    monkeypatch.setattr(sys, "argv", ["run", "control", "shard", "chaos"])
    with pytest.raises(SystemExit, match=r"\['control', 'shard', 'chaos'\]"):
        t_run.main()
    assert capsys.readouterr().err.count("no CUDA device") == 3
    assert not list(tmp_path.glob("BENCH_*.json"))
