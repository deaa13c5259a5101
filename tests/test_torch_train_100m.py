"""``repro_torch.examples.train_100m`` against the reference's
``examples/train_100m.py``, on the CPU.

- ``model_100m()`` is the reference's model, field for field.
- At a narrow depth (2 of 12 layers, the published widths) in float32, the
  first three steps' losses equal the reference's run (its jitted
  ``make_train_step``, ``OptConfig(lr=6e-4, warmup_steps=30)``, the
  synthetic stream at B 4 x S 128), the reference's initial parameters
  carried across with ``convert.model_params``: rtol 2e-5, the three-step
  tolerance of ``test_torch_train_step.py``.
- A run stopped after step 2 and resumed from its checkpoint ends bit for
  bit where the uninterrupted 4-step run ends: every state leaf and the
  last loss, under
  ``torch.use_deterministic_algorithms(True)`` (with two threads the CPU's
  reductions otherwise differ from run to run by an ulp).
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import make_batch_iterator as j_batches  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import train_step as j_ts  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.examples import train_100m  # noqa: E402
from repro_torch.models.spec import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STEP_RTOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_train_100m", ROOT / "examples" / "train_100m.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_model_100m_equals_reference():
    want = _reference_example().model_100m()
    got = train_100m.model_100m()
    assert convert.model_config(_fields(want)) == got
    assert got.param_count() == want.param_count()


def _narrow():
    """(reference config, port config): 2 layers, float32 compute."""
    want = dataclasses.replace(_reference_example().model_100m(), num_layers=2,
                               compute_dtype=jnp.float32)
    return want, convert.model_config(_fields(want))


def test_first_losses_equal_reference(tmp_path):
    jcfg, tcfg = _narrow()
    steps = 3
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    jopt = j_opt.OptConfig(lr=6e-4, warmup_steps=30, total_steps=steps)
    jstate = j_ts.TrainState(jparams, j_opt.adamw_init(jparams, jopt))
    step_fn = jax.jit(j_ts.make_train_step(jcfg, jopt, None))
    it = j_batches(JDataConfig(seq_len=128, global_batch=4, seed=0), jcfg)
    want = []
    for _ in range(steps):
        _, batch = next(it)
        jstate, met = step_fn(jstate, jax.tree.map(jnp.asarray, batch))
        want.append(float(met["loss"]))
    it.close()

    tparams = convert.model_params(jax.tree.map(np.asarray, jparams), "cpu")
    _, losses = train_100m.train(tcfg, steps=steps, ckpt=str(tmp_path / "ck"),
                                 device="cpu", params=tparams, verbose=False)
    np.testing.assert_allclose([float(x) for x in losses], want, rtol=STEP_RTOL)


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def test_resume_equals_uninterrupted(tmp_path, deterministic):
    _, cfg = _narrow()
    whole, losses = train_100m.train(cfg, steps=4, save_every=2, ckpt=str(tmp_path / "a"),
                                     device="cpu", verbose=False)
    assert sorted(p.name for p in (tmp_path / "a").glob("step_*")) == \
        ["step_00000002", "step_00000004"]
    _, head = train_100m.train(cfg, steps=4, save_every=2, ckpt=str(tmp_path / "b"),
                               stop_after=2, device="cpu", verbose=False)
    assert len(head) == 2 and torch.equal(head[-1], losses[1])
    assert [p.name for p in (tmp_path / "b").glob("step_*")] == ["step_00000002"]
    resumed, tail = train_100m.train(cfg, steps=4, save_every=2, ckpt=str(tmp_path / "b"),
                                     resume=True, device="cpu", verbose=False)
    assert len(tail) == 2
    assert torch.equal(tail[-1], losses[-1])
    is_t = lambda x: isinstance(x, torch.Tensor)  # noqa: E731
    for a, b in zip(tree_leaves(whole, is_t), tree_leaves(resumed, is_t), strict=True):
        assert torch.equal(a, b)
