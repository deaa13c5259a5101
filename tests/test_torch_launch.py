"""The port's launch tooling (``repro_torch.launch.specs``, ``hlo_analysis``,
``dryrun``, ``report``, ``configs.cells``) and the ``roofline`` section,
against the reference's where both compute the same thing.

- ``cells()`` (33: 40 less 7 ``long_500k`` skips), ``preferred_rules_name``,
  ``batch_specs``, ``rules_for_shape`` and ``model_flops_for_cell`` equal
  the reference's for every arch x shape, at the published widths (specs
  only: nothing is allocated).
- The ring model prices ``tests/test_launch.py``'s four collectives at the
  reference parser's wire and payload bytes.
- The dry run, in a subprocess (the ``fake`` process group is
  process-global): a smoke train cell on a fake 2 x 4 mesh issues
  all-reduces or reduce-scatters with wire > 0; a matmul sharded over both
  axes counts the global flops over 8 on rank 0; on a 1 x 1 mesh the
  counted flops equal ``FlopCounterMode`` over a real unsharded step; a
  probe record written there is read by the port's ``CostModel``, the
  ``roofline`` section (one row per probe, ``roofline_missing`` before)
  and the report.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs as jconfigs  # noqa: E402
from repro.launch import hlo_analysis as jh  # noqa: E402
from repro.launch import specs as js  # noqa: E402
from repro.sharding import rules as jr  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.benchmarks import roofline as t_roofline  # noqa: E402
from repro_torch.core import cost_model as t_cm  # noqa: E402
from repro_torch.launch import hlo_analysis as th  # noqa: E402
from repro_torch.launch import report as t_report  # noqa: E402
from repro_torch.launch import specs as ts  # noqa: E402
from repro_torch.sharding import rules as tr  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
_DTYPES = {"int32": torch.int32, "float32": torch.float32}


def test_cells_and_preferred_rules_equal_reference():
    cells = tconfigs.cells()
    assert cells == jconfigs.cells()
    assert len(cells) == 33
    for arch, shape in cells:
        assert tconfigs.preferred_rules_name(arch, shape) == \
            jconfigs.preferred_rules_name(arch, shape)
    assert tconfigs._PREFERRED == jconfigs._PREFERRED


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_batch_specs_and_rules_equal_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for shape in tconfigs.SHAPES:
        want, got = js.batch_specs(jcfg, shape), ts.batch_specs(tcfg, shape)
        assert got.keys() == want.keys()
        meta = ts.input_specs(tcfg, shape)
        for k, w in want.items():
            assert got[k].shape == tuple(w.shape)
            assert got[k].logical_axes == w.logical_axes
            assert got[k].dtype == _DTYPES[str(jax.numpy.dtype(w.dtype))]
            assert meta[k].device.type == "meta" and tuple(meta[k].shape) == w.shape
        assert ts.rules_for_shape(tcfg, shape, tr.DEFAULT_RULES).rules == \
            js.rules_for_shape(jcfg, shape, jr.DEFAULT_RULES).rules


def test_model_flops_equal_reference():
    for arch, shape in tconfigs.cells():
        assert th.model_flops_for_cell(tconfigs.get_config(arch), shape) == \
            jh.model_flops_for_cell(jconfigs.get_config(arch), shape), (arch, shape)


def test_ring_model_equals_reference_parser():
    hlo = """
  %ag = f32[16,256]{1,0} all-gather(%x), replica_groups=[16,16]<=[256], dimensions={0}
  %ar = (bf16[8,128]{1,0}, bf16[8,128]{1,0}) all-reduce(%a, %b), replica_groups=[32,8]<=[256]
  %rs = f32[4,64]{1,0} reduce-scatter(%y), replica_groups={{0,1,2,3}}
  %cp = f32[2,2]{1,0} collective-permute(%z)
  %done = f32[1]{0} all-reduce-done(%w)
"""
    want = jh.parse_collectives(hlo, num_devices=256)
    records = [("all-gather", 16 * 256 * 4, 16), ("all-reduce", 2 * 8 * 128 * 2, 8),
               ("reduce-scatter", 4 * 64 * 4, 4), ("collective-permute", 2 * 2 * 4, None)]
    got = th.parse_collectives(records, num_devices=256)
    assert got.counts == want.counts
    assert got.wire_bytes == want.wire_bytes
    assert got.payload_bytes == want.payload_bytes
    assert got.by_op_bytes == want.by_op_bytes


DRYRUN = textwrap.dedent("""
    import json, logging, sys
    from pathlib import Path
    import numpy as np, torch
    logging.disable(logging.WARNING)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    import repro_torch.configs as configs
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import cost_model
    from repro_torch.data import random_batch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import init_params
    from repro_torch.sharding.rules import DEFAULT_RULES
    from repro_torch.train import OptConfig, TrainState, adamw_init, make_train_step

    cost_model.DRYRUN_DIR = Path(sys.argv[1])
    cfg = get_smoke_config("qwen3-4b")
    res = {}

    # 1 x 1: the counted flops of a train step equal FlopCounterMode's
    dryrun.init_fake_world(1)
    with dryrun.extra_shape("tiny", 32, 2, "train") as shape:
        _, counts, _ = dryrun.count_cell(cfg, shape, make_test_mesh(1, 1), DEFAULT_RULES)
    params = init_params(cfg, 0, device="cpu")
    state = TrainState(params, adamw_init(params, OptConfig()))
    batch = {k: torch.from_numpy(v)
             for k, v in random_batch(cfg, 2, 32, np.random.default_rng(0)).items()}
    with FlopCounterMode(display=False) as fc:
        make_train_step(cfg, OptConfig())(state, batch)
    res["flops_1x1"] = [counts["flops"], fc.get_total_flops()]

    # 2 x 4: a train cell's collectives; a sharded matmul's flops
    dryrun.init_fake_world(8)
    mesh = make_test_mesh(2, 4)
    with dryrun.extra_shape("tiny", 32, 8, "train") as shape:
        cell, counts, _ = dryrun.count_cell(cfg, shape, mesh, DEFAULT_RULES)
    stats = dryrun.parse_collectives(counts["records"], 8)
    res["counts"], res["wire"] = stats.counts, stats.wire_bytes
    res["peak"] = counts["memory_stats"]["peak_bytes"]
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        a = DTensor.from_local(torch.empty(128, 512), mesh, [Shard(0), Replicate()],
                               run_check=False)
        b = DTensor.from_local(torch.empty(512, 256), mesh, [Replicate(), Shard(1)],
                               run_check=False)
    counter = dryrun.LocalCounter()
    with counter:
        c = a @ b
    res["matmul"] = [counter.flops, 2 * 256 * 512 * 1024]

    # a probe record, read back by the test's process
    configs.SHAPES["train_4k"] = (32, 8, "train")
    rec = dryrun.probe_roofline("qwen3-4b", "train_4k", False, "default",
                                verbose=False, cfg=cfg, mesh=mesh)
    dryrun.run_cell("qwen3-4b", "train_4k", False, "default", verbose=False,
                    cfg=cfg, mesh=mesh)
    res["probe"] = rec
    print(json.dumps(res))
""")


@pytest.fixture(scope="module")
def dryrun_result(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_torch")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", DRYRUN, str(out)], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return out, json.loads(proc.stdout.strip().splitlines()[-1])


def test_dryrun_counts_local_shards(dryrun_result):
    _, res = dryrun_result
    got, want = res["flops_1x1"]
    assert got == want > 0
    got, glob = res["matmul"]
    assert got == glob // 8
    assert any(op in res["counts"] for op in ("all-reduce", "reduce-scatter"))
    assert res["wire"] > 0 and res["peak"] > 0


def test_cost_model_roofline_and_report_read_the_probe(dryrun_result, monkeypatch, capsys):
    out, res = dryrun_result
    rec = res["probe"]
    assert json.loads((out / "pod16x16" / "qwen3-4b__train_4k__default__probe.json")
                      .read_text()) == rec
    for key in ("flops_per_device", "bytes_per_device", "collective_wire_bytes",
                "compute_seconds", "memory_seconds", "collective_seconds", "dominant",
                "model_flops_global", "useful_flops_ratio", "collectives",
                "collective_bytes_by_op", "probe_units", "total_units"):
        assert key in rec
    assert rec["compute_seconds"] == rec["flops_per_device"] / th.PEAK_FLOPS

    monkeypatch.setattr(t_cm, "DRYRUN_DIR", out / "none")
    t_roofline.main()
    assert capsys.readouterr().out.startswith("roofline_missing,0.0,")

    monkeypatch.setattr(t_cm, "DRYRUN_DIR", out)
    step = max(rec["compute_seconds"], rec["memory_seconds"], rec["collective_seconds"])
    assert t_cm.CostModel().step_seconds("qwen3-4b", "train_4k", chips=64) == \
        step * t_cm.REFERENCE_CHIPS / 64
    t_roofline.main()
    rows = capsys.readouterr().out.strip().splitlines()
    assert len(rows) == 1
    assert rows[0].startswith(f"roofline_qwen3-4b_train_4k_default,{step * 1e6:.1f},"
                              f"dominant={rec['dominant']};")
    assert rows[0].endswith(f"fits_hbm={rec['fits_hbm']}")
    table = t_report.roofline_table("pod16x16", root=out)
    assert "| qwen3-4b | train_4k | default |" in table
    assert "fits 80GB" in t_report.dryrun_table("pod16x16", root=out)
