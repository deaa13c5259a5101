"""The port's scoring suites against the JAX package's, on the CPU.

Sections ``control``, ``stream``, ``shard``, ``dtrace``, ``obs`` and
``capacity`` of ``repro_torch.benchmarks`` run at the JAX package's smoke
shapes (``BENCH_FAST``) with ``device="cpu"`` (each kernel's plain
version) beside the JAX package's ``benchmarks/`` sections.  Row names
must be equal, and every derived field that is not a host time
(``run.HOST_TIME_KEYS``), in order; no wall-clock value is compared.

``control`` and ``stream`` run in process.  The sharded sections sweep
shard counts: the port puts every logical shard on one device, the
reference clips to its visible JAX devices, so they are held against one
run of the reference's four sections with 8 forced host devices
(``conftest.run_forced_devices_subprocess``).  The port's pick at S = 2,
4 and 8 must equal its pick at S = 1.

Renamed rows (the port names its paths, not the reference's XLA and
interpret-mode ones): ``eirate_plain_*`` is the reference's
``eirate_xla_*``, ``eirate_cuda_*`` its ``eirate_pallas_interpret_*``, and
``gp_readout_plain_*`` its ``gp_readout_xla_*``; ``gp_readout_cuda_*`` is
new.  A ``*_cuda_*`` row's derived fields are its plain twin's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from benchmarks import common as j_common  # noqa: E402  (repo root on sys.path)
from benchmarks import control_plane as JC  # noqa: E402
from benchmarks import stream_churn as JS  # noqa: E402
from repro_torch.benchmarks import common  # noqa: E402
from repro_torch.benchmarks import control_plane as TC  # noqa: E402
from repro_torch.benchmarks import run as t_run  # noqa: E402
from repro_torch.benchmarks import shard_scale as TSS  # noqa: E402
from repro_torch.benchmarks import stream_churn as TS  # noqa: E402

RENAMED = {"eirate_plain_": "eirate_xla_",
           "eirate_cuda_": "eirate_pallas_interpret_",
           "gp_readout_plain_": "gp_readout_xla_"}

SHARDED = ("shard", "dtrace", "obs", "capacity")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The port's CPU ops here run as thousands of tiny calls; under
    pytest-xdist the idle OpenMP threads of each worker spin against the
    other workers', so this module runs them on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fast(monkeypatch):
    """Smoke shapes in both packages: the reference's modules that bind
    ``FAST`` at import get it patched too."""
    monkeypatch.setattr(common, "FAST", True)
    monkeypatch.setattr(j_common, "FAST", True)
    for mod in (JC, JS):
        monkeypatch.setattr(mod, "FAST", True)


def _reference_name(name: str) -> str:
    for port, ref in RENAMED.items():
        if name.startswith(port):
            return ref + name[len(port):]
    return name


def test_control_rows_equal_reference(fast):
    want = t_run.comparable("control", common.capture_rows(JC.main))
    got = t_run.comparable("control", common.capture_rows(TC.main, device="cpu"))
    by_name = dict(got)
    for name, derived in got:
        if "_cuda_" in name:
            assert derived == by_name[name.replace("_cuda_", "_plain_")], name
    got_names = [_reference_name(n) for n, _ in got
                 if not n.startswith("gp_readout_cuda_")]
    assert got_names == [n for n, _ in want]
    assert [(_reference_name(n), d) for n, d in got if "_cuda_" not in n] == [
        (n, d) for n, d in want if "pallas_interpret" not in n]
    assert [n for n, _ in got] == [
        "eirate_plain_n2500_N50", "eirate_cuda_n2500_N50",
        "gp_readout_plain_k1250_n2500", "gp_readout_cuda_k1250_n2500",
        "gp_engine_dense_n1000", "gp_engine_block_n1000"]


def test_stream_rows_equal_reference(fast):
    want = t_run.comparable("stream", common.capture_rows(JS.main))
    got = t_run.comparable("stream", common.capture_rows(TS.main, device="cpu"))
    assert got == want
    assert [n for n, _ in got] == [
        "stream_churn_end_to_end", "stream_decision_fused_L2000",
        "stream_decision_ops_L2000", "stream_decision_sharded_L2000"]


REFERENCE_8_DEVICES = """
import contextlib, io, json, os, sys
os.environ["BENCH_FAST"] = "1"
sys.path.insert(0, {root!r})
from benchmarks import capacity, decision_trace, obs_overhead, shard_scale
out = {{}}
for name, mod in (("shard", shard_scale), ("dtrace", decision_trace),
                  ("obs", obs_overhead), ("capacity", capacity)):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    out[name] = buf.getvalue()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_8_devices(request):
    """The reference's sharded sections at smoke shapes on 8 forced host
    devices, once for the module: section -> captured stdout."""
    from pathlib import Path

    from conftest import run_forced_devices_subprocess
    root = str(Path(request.config.rootpath))
    return run_forced_devices_subprocess(REFERENCE_8_DEVICES.format(root=root))


@pytest.mark.parametrize("section", SHARDED)
def test_sharded_rows_equal_reference_on_eight_devices(section, fast,
                                                       reference_8_devices):
    import importlib
    mod = importlib.import_module(f"repro_torch.benchmarks.{t_run.MODULES[section]}")
    want = t_run.comparable(section, common.parse_rows(reference_8_devices[section]))
    got = t_run.comparable(section, common.capture_rows(mod.main, device="cpu"))
    assert got == want
    shards = {dict(d).get("shards") for _, d in got} - {None}
    assert shards == ({"1", "2", "4", "8"} if section == "shard" else {"1", "8"})


@pytest.mark.parametrize("n", [2048, 10_000])
def test_picks_equal_across_shard_counts(n):
    """The sharded decision is exact: at S = 2, 4 and 8 logical shards the
    pick (and the whole top-k) is the S = 1 one, on the same state."""
    picks = {}
    for s in (1, 2, 4, 8):
        sc, args = TSS._setup(n, s, "cpu")
        v, g = sc.readout_decide_topk(*args)
        picks[s] = (v.tolist(), g.tolist())
    assert all(picks[s] == picks[1] for s in (2, 4, 8)), picks
    assert np.isfinite(picks[1][0]).all()
