"""The port's axis rules (``repro_torch.sharding``) against the reference's
(``repro.sharding.rules``), and a real sharded train step on DTensor.

- The six tables, ``lookup``, ``override``, ``mesh_axes``' deduplication and
  ``_sanitize_pspec`` equal the reference's, name for name.
- Every parameter, cache and batch leaf of each family's smoke config gets
  the reference's sanitised ``PartitionSpec`` on a 2 x 4 mesh (the
  reference's ``FakeMesh`` trick: sanitising needs only the mesh's axis
  names and sizes), as DTensor placements.
- On a threaded 2 x 4 mesh (``multi_threaded_pg``, eight ranks in one
  subprocess, since process groups are process-global): smoke qwen3-4b's
  (in float32: in bf16 a partial sum rounds where the unsharded sum does
  not, and the gradients part by up to 2e-2 of a leaf's largest)
  ``make_train_step(cfg, opt, DEFAULT_RULES)`` loss equals the unsharded
  port step's and the reference's unsharded step's to float32 tolerance
  (rtol 2e-5, ``test_torch_train_step.py``'s step tolerance: the sharded
  sums run in another order), every parameter after the step is the
  unsharded step's within 2e-2 of its learning rate beyond one ulp of its
  value, ``wq`` has 4 distinct
  shards, and a dim
  held by ("pod", "data") on a 2 x 2 x 2 mesh is split pod-major, as
  GSPMD splits ``P(("pod", "data"))``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import specs as j_specs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.sharding import rules as jr  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import train_step as j_ts  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.data import random_batch  # noqa: E402
from repro_torch.launch import specs as t_specs  # noqa: E402
from repro_torch.models.model import make_cache_specs, model_specs  # noqa: E402
from repro_torch.models.spec import ParamSpec  # noqa: E402
from repro_torch.sharding import rules as tr  # noqa: E402
from repro_torch.train import OptConfig, TrainState, adamw_init, make_train_step  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
TABLES = ("DEFAULT_RULES", "FSDP_RULES", "SP_DECODE_RULES", "PUREDP_RULES",
          "QROWS_RULES", "SCORING_RULES")
STEP_RTOL = 2e-5


def _names():
    return sorted({k for t in TABLES for k, _ in getattr(jr, t).rules}) + [None, "nope"]


@pytest.mark.parametrize("table", TABLES)
def test_tables_equal_reference(table):
    j, t = getattr(jr, table), getattr(tr, table)
    assert t.rules == j.rules
    for name in _names():
        assert t.lookup(name) == j.lookup(name), name
    assert t.override(heads=None, batch="data").rules == \
        j.override(heads=None, batch="data").rules


@pytest.mark.parametrize("table", TABLES)
def test_mesh_axes_dedup_equals_reference(table):
    j, t = getattr(jr, table), getattr(tr, table)
    names = _names()
    cases = [("heads", "mlp"), ("batch", "seq", "embed"), ("embed", "mlp"),
             ("batch", "experts", None, "expert_mlp"), ("vocab", "embed"),
             ("batch", "kv_seq", "kv_heads", "head_dim"), ("models", "tenants")]
    cases += [(a, b) for a in names for b in names]
    for axes in cases:
        assert t.mesh_axes(axes) == tuple(j.mesh_axes(axes)), axes


class JFakeMesh:
    """The reference test's stand-in: ``_sanitize_pspec`` reads only
    ``mesh.shape``."""

    def __init__(self, sizes):
        self.shape = dict(sizes)


def _tmesh(sizes):
    return SimpleNamespace(mesh_dim_names=tuple(sizes), shape=tuple(sizes.values()))


def test_sanitize_equals_reference():
    from jax.sharding import PartitionSpec as P

    cases = [  # test_sharding.py's two, and the cases the issue names
        (P("model", "data"), (6, 4), {"data": 2, "model": 4}),
        (P(("pod", "data"), None), (4, 4), {"data": 2, "model": 4}),
        (P(None, "model"), (4, 1), {"data": 2, "model": 4}),           # MQA kv head
        (P(None, "model", None), (1024, 24, 64), {"data": 16, "model": 16}),  # musicgen
        (P(("pod", "data"), "model"), (8, 8), {"pod": 2, "data": 2, "model": 2}),
        (P(("pod", "data", "model")), (6,), {"pod": 2, "data": 2, "model": 2}),
        (P("data", None, "model"), (2, 3, 4), {"data": 2, "model": 4}),
    ]
    for spec, shape, sizes in cases:
        want = jr._sanitize_pspec(spec, shape, JFakeMesh(sizes))
        got = tr._sanitize_pspec(tuple(spec), shape, _tmesh(sizes))
        assert got == tuple(want) + (None,) * (len(got) - len(want)), (spec, shape)


def _paths(tree, prefix=()):
    """(path, leaf) of a spec tree, named-tuple fields by name."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _paths(getattr(tree, k), prefix + (k,))
    else:
        yield prefix, tree


def _placements_of(pspec, names):
    """Placements a sanitised reference spec stands for: Shard(d) on every
    mesh dim that dim d is mapped to."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(names)
    for d, part in enumerate(pspec):
        for a in (part if isinstance(part, tuple) else (part,)) if part else ():
            out[names.index(a)] = Shard(d)
    return tuple(out)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_leaf_placements_equal_reference(arch):
    sizes = {"data": 2, "model": 4}
    jmesh, tmesh = JFakeMesh(sizes), _tmesh(sizes)
    jcfg, tcfg = j_smoke(arch), get_smoke_config(arch)
    trees = [(jmodel.model_specs(jcfg), model_specs(tcfg)),
             (jmodel.make_cache_specs(jcfg, 8, 72), make_cache_specs(tcfg, 8, 72))]
    for shape in ("train_4k", "decode_32k"):
        trees.append((j_specs.batch_specs(jcfg, shape), t_specs.batch_specs(tcfg, shape)))
    for table in ("DEFAULT_RULES", "FSDP_RULES", "PUREDP_RULES", "QROWS_RULES"):
        jrules, trules = getattr(jr, table), getattr(tr, table)
        for jtree, ttree in trees:
            jleaves, tleaves = dict(_paths(jtree)), dict(_paths(ttree))
            assert jleaves.keys() == tleaves.keys()
            for path, js in jleaves.items():
                ts = tleaves[path]
                assert tuple(ts.shape) == tuple(js.shape), path
                want = jr._sanitize_pspec(jr.logical_to_pspec(js, jrules), js.shape, jmesh)
                want = tuple(want) + (None,) * (len(js.shape) - len(want))
                mesh, placements = tr.logical_sharding(ts, tmesh, trules)
                assert tr._sanitize_pspec(tr.logical_to_pspec(ts, trules), ts.shape,
                                          tmesh) == want, (table, path)
                assert placements == _placements_of(want, tmesh.mesh_dim_names), \
                    (table, path)


def test_with_logical_constraint_is_a_noop_without_rules_or_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert tr.with_logical_constraint(x, ("batch", "embed"), None) is x
    assert tr.with_logical_constraint(x, ("batch", "embed"), tr.DEFAULT_RULES) is x
    assert tr.current_mesh() is None


def test_kernel_ops_refuse_dtensors():
    """A sharded model runs the plain route: the kernel entry points name
    the DTensor they were handed and raise."""
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels import ops

    class Fake(DTensor):   # isinstance is all the guard reads
        def __new__(cls):
            return torch.Tensor._make_subclass(cls, torch.zeros(1))

    with pytest.raises(TypeError, match="DTensor"):
        ops.flash_attention(Fake(), Fake(), Fake())
    with pytest.raises(TypeError, match="DTensor"):
        ops.ssd_mix(Fake(), Fake(), Fake(), Fake(), Fake())


THREADED = textwrap.dedent("""
    import dataclasses, json, sys, threading
    import torch, torch.distributed as dist
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.testing._internal.distributed.multi_threaded_pg import _install_threaded_pg
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.spec import ParamSpec, tree_leaves
    from repro_torch.sharding.rules import (
        DEFAULT_RULES, distribute_tree, logical_sharding, mesh_context)
    from repro_torch.train import OptConfig, make_train_step, train_state_specs

    state, batch, want = torch.load(sys.argv[1], weights_only=False)
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"), compute_dtype=torch.float32)
    opt = OptConfig()
    specs = train_state_specs(cfg, opt)
    bspecs = {k: ParamSpec(tuple(v.shape), ("batch", "seq"), dtype=v.dtype)
              for k, v in batch.items()}
    full = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    out, errors = {}, []

    def rank(r, store):
        try:
            dist.init_process_group("threaded", rank=r, world_size=8, store=store)
            cube = make_test_mesh(2, 2, pod=2)
            x = distribute_tree(full, ParamSpec((8, 3), ("batch", None)), cube,
                                DEFAULT_RULES)
            mesh = make_test_mesh(2, 4)
            st = distribute_tree(state, specs, mesh, DEFAULT_RULES)
            b = distribute_tree(batch, bspecs, mesh, DEFAULT_RULES)
            with mesh_context(mesh):
                new, m = make_train_step(cfg, opt, DEFAULT_RULES)(st, b)
            wq = new.params["blocks"]["attn"]["wq"]
            is_t = lambda x: isinstance(x, torch.Tensor)
            # beyond one float32 ulp of the parameter's own value
            ulp = lambda b: torch.nextafter(b.abs(), torch.tensor(float("inf"))) - b.abs()
            err = max(float((((a.full_tensor() - b).abs()) - ulp(b)).max())
                      for a, b in zip(tree_leaves(new.params, is_t),
                                      tree_leaves(want, is_t), strict=True))
            out[r] = {"coord": cube.get_coordinate(), "param_err": err,
                      "rows": x.to_local()[:, 0].tolist(),
                      "loss": float(m["loss"].full_tensor()),
                      "wq": wq.to_local().flatten()[:8].tolist(),
                      "wq_placements": [str(p) for p in wq.placements]}
        except BaseException as e:
            import traceback
            errors.append(traceback.format_exc())
            raise
        finally:
            dist.destroy_process_group()

    ShardingPropagator._fake_mode_lock = threading.Lock()
    _install_threaded_pg()
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    store = dist.HashStore()
    threads = [threading.Thread(target=rank, args=(r, store)) for r in range(8)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    print(json.dumps({"out": out, "errors": errors}))
""")


def test_sharded_train_step_on_threaded_2x4_mesh(tmp_path):
    jcfg = dataclasses.replace(j_smoke("qwen3-4b"), compute_dtype=jnp.float32)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_smoke_config("qwen3-4b"), compute_dtype=torch.float32)
    tparams = convert.model_params(jax.tree.map(np.asarray, jparams), "cpu")
    batch = random_batch(tcfg, 8, 32, np.random.default_rng(0))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    opt = OptConfig()
    state = TrainState(tparams, adamw_init(tparams, opt))
    tnew, tmet = make_train_step(tcfg, opt)(state, tbatch)
    jopt = j_opt.OptConfig()
    jstate = j_ts.TrainState(jparams, j_opt.adamw_init(jparams, jopt))
    _, jmet = jax.jit(j_ts.make_train_step(jcfg, jopt, None))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    torch.save((state, tbatch, tnew.params), tmp_path / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", THREADED, str(tmp_path / "inputs.pt")],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not res["errors"], res["errors"][0]
    out = {int(r): v for r, v in res["out"].items()}
    assert sorted(out) == list(range(8))

    # ("pod", "data") splits the 8 rows pod-major: block p * 2 + d
    for v in out.values():
        p, d, _ = v["coord"]
        assert v["rows"] == [float(3 * i) for i in range((p * 2 + d) * 2, (p * 2 + d) * 2 + 2)]

    losses = {v["loss"] for v in out.values()}
    assert len(losses) == 1
    loss = losses.pop()
    np.testing.assert_allclose(loss, float(tmet["loss"]), rtol=STEP_RTOL)
    np.testing.assert_allclose(loss, float(jmet["loss"]), rtol=STEP_RTOL)
    assert {tuple(v["wq_placements"]) for v in out.values()} == {("R", "S(2)")}
    assert len({tuple(v["wq"]) for v in out.values()}) == 4
    # every rank's parameters after the step: the unsharded step's, within
    # 2e-2 of its learning rate (test_torch_train_step.py's STEP_TOL_OF_LR)
    # beyond one ulp of each parameter's value (lr is 3e-6 at step 1, below
    # the ulp of a norm scale near 1)
    lr = float(tmet["lr"])
    assert max(v["param_err"] for v in out.values()) <= 2e-2 * lr, \
        (lr, [v["param_err"] for v in out.values()])
