"""The port's engine suites against the JAX package's, on the CPU.

Sections ``devchurn``, ``eventlog`` and ``chaos`` of
``repro_torch.benchmarks`` run at the JAX package's smoke shapes
(``BENCH_FAST``) with ``device="cpu"`` (each kernel's plain version)
beside the JAX package's ``benchmarks/`` sections, in process: none
shards its scorer.  Row names must be equal, and every derived field that
is not a host time (``run.HOST_TIME_KEYS``), in order: trials, decisions,
scoring passes, regret, sessions served, stranded devices, snapshots.  No
wall-clock value is compared.  The gates the reference asserts at smoke
shapes run inside both sections (chaos: the regret bound and the stranded
counts); the rows are checked for them again here.
"""

import importlib

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from benchmarks import common as j_common  # noqa: E402  (repo root on sys.path)
from benchmarks import chaos as JCH  # noqa: E402
from benchmarks import device_churn as JD  # noqa: E402
from benchmarks import eventlog as JE  # noqa: E402
from repro_torch.benchmarks import common  # noqa: E402
from repro_torch.benchmarks import run as t_run  # noqa: E402

REFERENCE = {"devchurn": JD, "eventlog": JE, "chaos": JCH}

ROWS = {
    "devchurn": ["device_churn_assign_sequential", "device_churn_assign_batched",
                 "device_churn_regret_devplane", "device_churn_regret_oblivious",
                 "device_churn_autoscale_fixed", "device_churn_autoscale_autoscale"],
    "eventlog": ["eventlog_compact_full", "eventlog_compact_incremental",
                 "eventlog_snapshot", "eventlog_restore",
                 "eventlog_append_processed", "eventlog_end_to_end_overhead"],
    "chaos": ["chaos_twin", "chaos_hardened", "chaos_unsupervised"],
}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The port's CPU ops here run as thousands of tiny calls; under
    pytest-xdist the idle OpenMP threads of each worker spin against the
    other workers', so this module runs them on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("section", list(REFERENCE))
def test_rows_equal_reference(section, monkeypatch):
    monkeypatch.setattr(common, "FAST", True)
    monkeypatch.setattr(j_common, "FAST", True)
    if hasattr(REFERENCE[section], "FAST"):     # bound at import there
        monkeypatch.setattr(REFERENCE[section], "FAST", True)
    port = importlib.import_module(f"repro_torch.benchmarks.{t_run.MODULES[section]}")
    want = t_run.comparable(section, common.capture_rows(REFERENCE[section].main))
    rows = common.capture_rows(port.main, device="cpu")
    got = t_run.comparable(section, rows)
    assert got == want
    assert [n for n, _ in got] == ROWS[section]
    derived = {n: dict(d) for n, _, d in rows}
    if section == "devchurn":
        seq, bat = (derived[f"device_churn_assign_{m}"] for m in ("sequential", "batched"))
        # one batched scoring pass serves a whole wave: fewer passes, the
        # same launches and trials
        assert int(bat["scoring_passes"]) < int(seq["scoring_passes"])
        assert (bat["policy_launches"], bat["trials"]) == (seq["policy_launches"], seq["trials"])
    elif section == "eventlog":
        assert int(derived["eventlog_end_to_end_overhead"]["snapshots"]) > 0
        assert (derived["eventlog_compact_full"]["moves"]
                == derived["eventlog_compact_incremental"]["moves"])
    else:
        assert derived["chaos_hardened"]["stranded_devices"] == "0"
        assert int(derived["chaos_unsupervised"]["stranded_devices"]) > 0
        twin = float(derived["chaos_twin"]["regret_mean"])
        assert (float(derived["chaos_hardened"]["regret_mean"])
                <= port.REGRET_BOUND * twin + port.REGRET_SLACK)
