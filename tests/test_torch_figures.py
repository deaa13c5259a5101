"""The port's paper-figure drivers against the JAX drivers, on the CPU.

Both drivers run with the same arguments (the port's with
``device="cpu"``, which runs each kernel's plain version); their rows are
captured and parsed.  Every row's name and derived fields must be equal as
strings, row by row: the figures are decided by the trial sequences, which
are equal on these problems.  Only ``us_per_call``, a host time, may
differ.  Fig. 5 runs on a small Matérn problem (5 tenants x 8 models,
patched into both driver modules) at M in (1, 4) with 2 repeats: at the
paper's 50 x 50 the two packages' episodes part at a float32 tie
(``tests/test_torch_fig5_tie.py``).  The same holds for ``--engine
batched`` (the batched sweep engine), the random baseline's rows among
them; and the port's quickstart example prints the reference's lines.
"""

import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro.core as JC  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from benchmarks import fig2_single_device as J2  # noqa: E402  (repo root on sys.path)
from benchmarks import fig3_multi_device as J3  # noqa: E402
from benchmarks import fig4_four_devices as J4  # noqa: E402
from benchmarks import fig5_synthetic_speedup as J5  # noqa: E402
from benchmarks import common as j_common  # noqa: E402
from repro_torch.benchmarks import common  # noqa: E402
from repro_torch.benchmarks import fig2_single_device as T2  # noqa: E402
from repro_torch.benchmarks import fig3_multi_device as T3  # noqa: E402
from repro_torch.benchmarks import fig4_four_devices as T4  # noqa: E402
from repro_torch.benchmarks import fig5_synthetic_speedup as T5  # noqa: E402
from repro_torch.benchmarks import run as t_run  # noqa: E402

FIG5_SMALL = (5, 8)          # tenants x models of the patched Fig-5 problem
ROOT = Path(__file__).resolve().parents[1]


def _rows(text: str) -> list[tuple[str, str]]:
    """(name, derived) of each ``name,us_per_call,derived`` row; us_per_call
    must parse as a finite number."""
    rows = []
    for line in text.strip().splitlines():
        name, us, derived = line.split(",", 2)
        assert float(us) >= 0.0, line
        rows.append((name, derived))
    return rows


def _small_fig5(monkeypatch):
    for mod, pkg in ((J5, JC), (T5, TC)):
        make = pkg.synthetic_matern_problem
        monkeypatch.setattr(
            mod, "synthetic_matern_problem",
            lambda num_users, num_models_per_user, seed, make=make:
                make(*FIG5_SMALL, seed=seed))
        monkeypatch.setattr(mod, "DEVICES", (1, 4))


CASES = {
    "fig2": (lambda: J2.run(1, "fig2", "event", 1),
             lambda: T2.run(1, "fig2", "event", 1, device="cpu"), None),
    "fig3": (J3.main, lambda: T3.main(device="cpu"), ["fig3", "--seeds", "1"]),
    "fig4": (J4.main, lambda: T4.main(device="cpu"), ["fig4", "--seeds", "1"]),
    "fig5": (lambda: J5.run_event(2), lambda: T5.run_event(2, device="cpu"), None),
}


@pytest.mark.parametrize("fig", list(CASES))
def test_rows_equal_reference(fig, capsys, monkeypatch):
    ref, port, argv = CASES[fig]
    if argv is not None:
        monkeypatch.setattr(sys, "argv", argv)
    if fig == "fig5":
        _small_fig5(monkeypatch)
    ref()
    want = _rows(capsys.readouterr().out)
    port()
    got = _rows(capsys.readouterr().out)
    assert got == want
    n_rows = {"fig2": 6, "fig3": 8, "fig4": 6, "fig5": 2}[fig]
    assert len(got) == n_rows
    # every threshold was reached in these runs
    for _, derived in got:
        fields = dict(kv.split("=") for kv in derived.split(";"))
        assert all(v not in ("nan", "inf") for k, v in fields.items()
                   if k.startswith("t_reach_")), derived


def _small_fig5_batched(monkeypatch):
    """The batched Fig. 5 on the small problem: its prior and its per-seed
    z draws both patched, in both driver modules."""
    _small_fig5(monkeypatch)
    for mod, pkg in ((J5, JC), (T5, TC)):
        draw = pkg.synthetic_matern_z
        monkeypatch.setattr(
            mod, "synthetic_matern_z",
            lambda num_users, num_models_per_user, seed, draw=draw:
                draw(*FIG5_SMALL, seed=seed))


BATCHED = {
    "fig2": (lambda: J2.run(1, "fig2", "batched", 2),
             lambda: T2.run(1, "fig2", "batched", 2, device="cpu"), None),
    "fig3": (J3.main, lambda: T3.main(device="cpu"),
             ["fig3", "--engine", "batched", "--seeds", "1"]),
    "fig4": (J4.main, lambda: T4.main(device="cpu"),
             ["fig4", "--engine", "batched", "--seeds", "1"]),
    "fig5": (J5.main, lambda: T5.main(device="cpu"),
             ["fig5", "--engine", "batched", "--seeds", "3"]),
}

#: left out of the comparison: wall_s, a host time (us_per_call, a host
#: time too, is not compared by _rows).  The random baseline draws the
#: reference's own threefry stream, so its rows and mdmt's speed-ups over it
#: are compared like the rest
BATCHED_EXCLUDED = ("wall_s",)


def _comparable(rows):
    out = []
    for name, derived in rows:
        pairs = [kv for kv in derived.split(";")
                 if kv.split("=")[0] not in BATCHED_EXCLUDED]
        out.append((name, pairs))
    return out


@pytest.mark.parametrize("fig", list(BATCHED))
def test_batched_rows_equal_reference(fig, capsys, monkeypatch):
    """``--engine batched``: the port's rows equal the JAX drivers' batched
    rows, the random baseline's among them, less the host times."""
    ref, port, argv = BATCHED[fig]
    if argv is not None:
        monkeypatch.setattr(sys, "argv", argv)
    if fig == "fig5":
        _small_fig5_batched(monkeypatch)
    ref()
    want = _rows(capsys.readouterr().out)
    port()
    got = _rows(capsys.readouterr().out)
    assert [name for name, _ in got] == [name for name, _ in want]
    assert _comparable(got) == _comparable(want)
    n_rows = {"fig2": 6, "fig3": 8, "fig4": 6, "fig5": 3}[fig]
    assert len(got) == n_rows
    for name, derived in got:
        fields = dict(kv.split("=") for kv in derived.split(";"))
        assert all(v not in ("nan", "inf") for k, v in fields.items()
                   if k.startswith("t_reach_")), derived


def test_quickstart_prints_reference_lines(capsys):
    """The port's quickstart prints the reference example's lines."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import quickstart as ref_quickstart
    finally:
        sys.path.pop(0)
    from repro_torch.examples import quickstart
    ref_quickstart.main()
    want = capsys.readouterr().out
    quickstart.main(device="cpu")
    got = capsys.readouterr().out
    assert got == want
    assert "faster than round robin" in got


@pytest.mark.parametrize("argv", [
    ["fig5", "--bogus"], ["--seeds", "0"], ["--engine", "scan"], ["--smoke"]])
def test_parse_engine_args_rejects_as_reference(argv, monkeypatch):
    for mod in (j_common, common):
        monkeypatch.setattr(mod, "FAST", False)
    for parse in (j_common.parse_engine_args, common.parse_engine_args):
        with pytest.raises(SystemExit):
            parse(argv)


def test_parse_engine_args_accepts_sections():
    got = common.parse_engine_args(["fig2", "fig5", "--seeds", "3"])
    want = j_common.parse_engine_args(["fig2", "fig5", "--seeds", "3"])
    assert vars(got) == vars(want) == {"engine": "event", "seeds": 3, "smoke": False}


def test_suite_payload_and_cpu_stamp(tmp_path, capsys):
    common.begin_suite("torch_unit")
    common.emit("row_a", 12.34, t_reach_0p01="7", ideal=4)
    path = common.end_suite(tmp_path)
    assert capsys.readouterr().out == "row_a,12.3,t_reach_0p01=7;ideal=4\n"
    payload = json.loads(path.read_text())
    assert path.name == "BENCH_torch_unit.json"
    assert payload["schema_version"] == common.BENCH_SCHEMA_VERSION
    assert payload["rows"] == {"row_a": {"us_per_call": 12.3,
                                         "t_reach_0p01": "7", "ideal": "4"}}
    env = payload["environment"]
    if not torch.cuda.is_available():
        assert (env["device_kind"], env["device_count"]) == ("none", 0)
    # a failed section writes nothing
    common.begin_suite("torch_aborted")
    common.emit("row_b", 1.0)
    common.abort_suite()
    assert common.end_suite(tmp_path) is None
    assert not (tmp_path / "BENCH_torch_aborted.json").exists()


def test_cli_needs_a_card(tmp_path, monkeypatch, capsys):
    """The CLI runs on the card; without one each section fails and no
    BENCH file is written."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would run the figure")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["run", "fig2", "--seeds", "1"])
    with pytest.raises(SystemExit, match="fig2"):
        t_run.main()
    assert "no CUDA device" in capsys.readouterr().err
    assert not list(tmp_path.glob("BENCH_*.json"))
