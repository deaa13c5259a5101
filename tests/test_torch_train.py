"""The trial executor's first modules against the reference, on the CPU:
the data pipeline, AdamW, gradient compression and the cost model.

Tolerances, each stated where it is used:

- pipeline batches: bit for bit (both are numpy, same generators, same keys);
- ``lr_at``: 1 float32 ulp (jnp's and torch's cos may round apart), and
  where 1 + cos cancels at the cosine's end, that ulp carried through;
- AdamW float32 leaves and metrics: rtol 1e-6 (``global_norm`` sums each
  leaf in another order, and pow and cos may round apart); bf16 leaves
  (params, and moments stored in bf16): one bf16 ulp of the reference's
  value, since one float32 ulp before the cast can flip the rounding;
- compression: codes and scales exactly, ``new_err`` to 1 float32 ulp;
- the cost model: exactly, with the port's hardware constants patched to
  the reference's (test data only; the port's own are the H100's).
"""

import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.core import cost_model as j_cm  # noqa: E402
from repro.data import pipeline as j_pipe  # noqa: E402
from repro.devplane.registry import DeviceClass as JDeviceClass  # noqa: E402
from repro.launch import hlo_analysis  # noqa: E402
from repro.models.model import model_specs as j_model_specs  # noqa: E402
from repro.sharding.rules import ParamSpec as JParamSpec  # noqa: E402
from repro.train import compress as j_comp  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config  # noqa: E402
from repro_torch.core import cost_model as t_cm  # noqa: E402
from repro_torch.data import pipeline as t_pipe  # noqa: E402
from repro_torch.devplane.registry import DeviceClass as TDeviceClass  # noqa: E402
from repro_torch.models import model_specs  # noqa: E402
from repro_torch.models.spec import ParamSpec, tree_leaves  # noqa: E402
from repro_torch.train import compress as t_comp  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402

BF16_ULP_BITS = 7            # bf16 keeps 7 explicit mantissa bits


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |x| (the spacing of the binade it lies in)."""
    a = np.maximum(np.abs(x.astype(np.float64)), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - BF16_ULP_BITS)


def _np(x) -> np.ndarray:
    """A torch tensor or jax array as float32 numpy (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# --- the data pipeline ------------------------------------------------------------

SHARDINGS = ((1, 0), (2, 1))          # (num_hosts, host_id)
STEPS = (0, 1, 7)


def _assert_batches_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("hosts", SHARDINGS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batches_bit_equal(arch, hosts):
    num_hosts, host_id = hosts
    kw = dict(seq_len=24, global_batch=4, seed=3, zipf_a=1.1,
              num_hosts=num_hosts, host_id=host_id)
    got = t_pipe.SyntheticLMStream(t_pipe.DataConfig(**kw), get_smoke_config(arch))
    want = j_pipe.SyntheticLMStream(j_pipe.DataConfig(**kw), j_get_smoke(arch))
    for step in STEPS:
        _assert_batches_equal(got.batch_at(step), want.batch_at(step))


@pytest.mark.parametrize("frontend", ["patches", "frames"])
def test_frontend_batches_bit_equal(frontend):
    """The vlm and audio branches, on a config that carries only the fields
    the stream reads (given to both)."""
    model_cfg = SimpleNamespace(frontend=frontend, frontend_dim=6,
                                num_frontend_tokens=5, num_lm_heads=3,
                                vocab_size=97)
    for num_hosts, host_id in SHARDINGS:
        kw = dict(seq_len=16, global_batch=4, seed=1, num_hosts=num_hosts,
                  host_id=host_id)
        got = t_pipe.SyntheticLMStream(t_pipe.DataConfig(**kw), model_cfg)
        want = j_pipe.SyntheticLMStream(j_pipe.DataConfig(**kw), model_cfg)
        for step in STEPS:
            _assert_batches_equal(got.batch_at(step), want.batch_at(step))


def test_iterator_replays_from_start_step():
    cfg = t_pipe.DataConfig(seq_len=8, global_batch=2, seed=5, prefetch=2)
    model_cfg = get_smoke_config("qwen3-4b")
    stream = t_pipe.SyntheticLMStream(cfg, model_cfg)
    it = t_pipe.make_batch_iterator(cfg, model_cfg, start_step=4)
    try:
        for want_step in (4, 5, 6):
            step, batch = next(it)
            assert step == want_step
            _assert_batches_equal(batch, stream.batch_at(want_step))
    finally:
        it.close()


def test_host_batch_must_divide():
    with pytest.raises(ValueError):
        t_pipe.DataConfig(seq_len=8, global_batch=3, num_hosts=2).host_batch


# --- AdamW -------------------------------------------------------------------------

def test_lr_at_within_one_ulp():
    steps = np.arange(301, dtype=np.int32)
    got = t_opt.lr_at(t_opt.OptConfig(), torch.from_numpy(steps)).numpy()
    want = np.asarray(j_opt.lr_at(j_opt.OptConfig(), jnp.asarray(steps)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_lr_at_through_the_cosine_end():
    """A schedule that runs out within the steps.  jnp's and torch's cos
    may round one float32 ulp apart (at most 2^-24 of a value in [-1, 1]);
    near the end 1 + cos cancels, so that ulp reaches lr as
    lr (1 - min_lr_ratio) / 2 x 2^-24, beside two ulps of lr's own
    roundings."""
    cfg_kw = dict(warmup_steps=20, total_steps=250)
    steps = np.arange(301, dtype=np.int32)
    got = t_opt.lr_at(t_opt.OptConfig(**cfg_kw), torch.from_numpy(steps)).numpy()
    want = np.asarray(j_opt.lr_at(j_opt.OptConfig(**cfg_kw), jnp.asarray(steps)))
    cfg = t_opt.OptConfig(**cfg_kw)
    bound = 2 * np.spacing(want) + cfg.lr * (1 - cfg.min_lr_ratio) / 2 * 2.0 ** -24
    assert np.all(np.abs(got - want) <= bound)
    np.testing.assert_array_equal(got[:cfg.warmup_steps + 1], want[:cfg.warmup_steps + 1])
    np.testing.assert_array_equal(got[250:], want[250:])


TREE = {"a": ((8, 5), "float32"), "b": {"c": ((16,), "bfloat16"),
                                       "d": ((3, 4, 2), "float32")},
        "e": ((6, 6), "bfloat16")}


def _leaf_paths(spec, prefix=()):
    for k, v in spec.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _trees(rng, scale):
    """The same numpy draws as a torch tree and a jnp tree, each leaf in its
    dtype (bf16 from float32 rounds to nearest even in both)."""
    t, j = {}, {}
    for path, (shape, dtype) in _leaf_paths(TREE):
        x = (scale * rng.standard_normal(shape)).astype(np.float32)
        tt, jt = t, j
        for k in path[:-1]:
            tt, jt = tt.setdefault(k, {}), jt.setdefault(k, {})
        tt[path[-1]] = torch.from_numpy(x).to(getattr(torch, dtype))
        jt[path[-1]] = jnp.asarray(x, getattr(jnp, dtype))
    return t, j


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _assert_leaves_close(got, want):
    """float32: rtol 1e-6; bf16: one bf16 ulp of the reference's value."""
    for path, _ in _leaf_paths(TREE):
        g, w = _get(got, path), _get(want, path)
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        gn, wn = _np(g), _np(w)
        if g.dtype == torch.bfloat16:
            assert np.all(np.abs(gn - wn) <= _bf16_ulp(wn)), path
        else:
            np.testing.assert_allclose(gn, wn, rtol=1e-6, atol=0, err_msg=str(path))


@pytest.mark.parametrize("grad_scale", [1.0, 0.01], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
def test_adamw_three_steps_against_reference(moment, grad_scale):
    rng = np.random.default_rng(7)
    tp, jp = _trees(rng, 1.0)
    t_cfg = t_opt.OptConfig(moment_dtype=getattr(torch, moment), warmup_steps=2)
    j_cfg = j_opt.OptConfig(moment_dtype=getattr(jnp, moment), warmup_steps=2)
    t_state, j_state = t_opt.adamw_init(tp, t_cfg), j_opt.adamw_init(jp, j_cfg)
    assert t_state["step"].dtype == torch.int32 and t_state["step"].shape == ()
    for _ in range(3):
        tg, jg = _trees(rng, grad_scale)
        tp, t_state, t_met = t_opt.adamw_update(tp, tg, t_state, t_cfg)
        jp, j_state, j_met = j_opt.adamw_update(jp, jg, j_state, j_cfg)
        _assert_leaves_close(tp, jp)
        _assert_leaves_close(t_state["mu"], j_state["mu"])
        _assert_leaves_close(t_state["nu"], j_state["nu"])
        assert int(t_state["step"]) == int(j_state["step"])
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(_np(t_met[k]), _np(j_met[k]), rtol=1e-6, atol=0)
    if grad_scale == 1.0:
        assert float(t_met["grad_norm"]) > t_cfg.clip_norm    # the clip was taken


def test_adamw_update_returns_new_tensors():
    rng = np.random.default_rng(1)
    tp, _ = _trees(rng, 1.0)
    before = {path: _get(tp, path).clone() for path, _ in _leaf_paths(TREE)}
    cfg = t_opt.OptConfig()
    state = t_opt.adamw_init(tp, cfg)
    new, new_state, _ = t_opt.adamw_update(tp, _trees(rng, 1.0)[0], state, cfg)
    for path, _ in _leaf_paths(TREE):
        assert torch.equal(_get(tp, path), before[path])
        assert _get(new, path) is not _get(tp, path)
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1
    with pytest.raises(ValueError):
        t_opt.adamw_update(tp, {"a": tp["a"]}, state, cfg)


def test_adamw_state_specs_match_reference():
    arch = "mamba2-1.3b"
    for t_mom, j_mom in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = t_opt.adamw_state_specs(model_specs(get_smoke_config(arch)),
                                      t_opt.OptConfig(moment_dtype=t_mom))
        want = j_opt.adamw_state_specs(j_model_specs(j_get_smoke(arch)),
                                       j_opt.OptConfig(moment_dtype=j_mom))
        assert sorted(got) == sorted(want) == ["mu", "nu", "step"]
        for key in ("mu", "nu", "step"):
            g = tree_leaves(got[key])
            w = jax.tree.leaves(want[key], is_leaf=lambda x: isinstance(x, JParamSpec))
            assert [(s.shape, s.logical_axes, s.init) for s in g] == \
                   [(s.shape, s.logical_axes, s.init) for s in w]
            assert [str(s.dtype).split(".")[-1] for s in g] == \
                   [jnp.dtype(s.dtype).name for s in w]
            assert all(isinstance(s, ParamSpec) for s in g)


# --- compression ---------------------------------------------------------------------

def _ties():
    """Values on exact halves of the scale (amax 127 -> scale 1): round half
    to even decides each code."""
    return np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5, -127.0,
                     0.0, 1e-3], np.float32)


@pytest.mark.parametrize("case", ["normal", "ties", "zeros", "tiny"])
def test_quantize_ef_against_reference(case):
    rng = np.random.default_rng(3)
    x = {"normal": rng.standard_normal(1000).astype(np.float32) * 3,
         "ties": _ties(),
         "zeros": np.zeros(17, np.float32),
         "tiny": (rng.standard_normal(64) * 1e-38).astype(np.float32)}[case]
    err = (rng.standard_normal(x.shape) * 1e-3).astype(np.float32) * (case != "ties")
    tq, ts, te = t_comp.quantize_ef(torch.from_numpy(x), torch.from_numpy(err))
    jq, js, je = j_comp.quantize_ef(jnp.asarray(x), jnp.asarray(err))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)
    np.testing.assert_array_max_ulp(te.numpy(), np.asarray(je), maxulp=1)
    if case == "ties":
        assert tq.numpy()[:9].tolist() == [127, 0, 2, 2, 0, -2, -2, 4, 126]


def test_compress_tree_against_reference():
    rng = np.random.default_rng(4)
    t_errs = j_errs = None
    for _ in range(3):
        tg, jg = _trees(rng, 1.0)
        t_errs = t_comp.init_error_state(tg) if t_errs is None else t_errs
        j_errs = j_comp.init_error_state(jg) if j_errs is None else j_errs
        tc, ts, t_errs = t_comp.compress_tree(tg, t_errs)
        jc, js, j_errs = j_comp.compress_tree(jg, j_errs)
        td, jd = t_comp.decompress_tree(tc, ts), j_comp.decompress_tree(jc, js)
        for path, _ in _leaf_paths(TREE):
            assert np.array_equal(_get(tc, path).numpy(), np.asarray(_get(jc, path)))
            assert _get(ts, path).item() == float(_get(js, path))
            np.testing.assert_array_max_ulp(_get(t_errs, path).numpy(),
                                            np.asarray(_get(j_errs, path)), maxulp=1)
            assert np.array_equal(_get(td, path).numpy(), np.asarray(_get(jd, path)))
    assert t_comp.wire_bytes_saved(tg) == j_comp.wire_bytes_saved(jg)
    with pytest.raises(ValueError):
        t_comp.quantize(tg["a"], bits=4)


@pytest.mark.parametrize("seed", range(8))
def test_error_feedback_sum_converges(seed):
    """The port's version of the reference's EF property: the sum of the
    dequantized transmissions plus the carried error equals the sum of the
    true signals (EF keeps quantized SGD unbiased)."""
    rng = np.random.default_rng(seed)
    xs = torch.from_numpy(rng.standard_normal((20, 64)).astype(np.float32))
    err = torch.zeros(64)
    sent = torch.zeros(64)
    for x in xs:
        q, s, err = t_comp.quantize_ef(x, err)
        sent += t_comp.dequantize(q, s)
    assert float((sent + err - xs.sum(0)).abs().max()) < 1e-3


def test_quantized_sgd_still_converges():
    """Least squares with int8 + EF gradients reaches the exact run's basin
    (the reference's property, on torch tensors)."""
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    loss = lambda w: float(((A @ w - b) ** 2).mean())
    grad = lambda w: 2.0 * A.T @ (A @ w - b) / b.numel()
    w_exact, w_q, err = torch.zeros(8), torch.zeros(8), torch.zeros(8)
    for _ in range(300):
        w_exact = w_exact - 0.05 * grad(w_exact)
        q, s, err = t_comp.quantize_ef(grad(w_q), err)
        w_q = w_q - 0.05 * t_comp.dequantize(q, s)
    floor = loss(torch.linalg.lstsq(A, b.unsqueeze(1)).solution.squeeze(1))
    assert abs(loss(w_q) - floor) < 0.05 * max(floor, 0.1)
    assert abs(loss(w_q) - loss(w_exact)) < 0.02


# --- the cost model ---------------------------------------------------------------------

@pytest.fixture
def reference_constants(tmp_path, monkeypatch):
    """Both cost models on the reference's hardware table (test data only)
    and an empty probe directory, so both take the analytic path."""
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(t_cm, name, getattr(hlo_analysis, name))
    monkeypatch.setattr(t_cm, "DRYRUN_DIR", tmp_path)
    monkeypatch.setattr(j_cm, "DRYRUN_DIR", tmp_path)
    return tmp_path


def test_h100_constants():
    assert (t_cm.PEAK_FLOPS, t_cm.HBM_BW, t_cm.ICI_BW, t_cm.HBM_PER_CHIP) == \
        (989e12, 3.35e12, 450e9, 80e9)


def test_no_tpu_constant_in_the_port():
    """The reference's hardware table (TPU v5e) appears nowhere in the port."""
    root = Path(__file__).resolve().parents[1]
    tpu = {repr(float(getattr(hlo_analysis, n)))
           for n in ("PEAK_FLOPS", "HBM_BW", "HBM_PER_CHIP")}
    spelled = {"197e12", "819e9", "16e9"} | tpu
    files = sorted((root / "src" / "repro_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    for path in files:
        text = path.read_text()
        assert not [c for c in spelled if c in text], path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_path_equals_reference(arch, reference_constants):
    got, want = t_cm.CostModel(), j_cm.CostModel()
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert (cfg.active_param_count() < cfg.param_count()) == (cfg.moe is not None)
    assert got._probe(arch, "train_4k") is None
    for shape in SHAPES:
        for chips in (1, 16, 256):
            assert got.step_seconds(arch, shape, chips) == want.step_seconds(arch, shape, chips)
            assert got.trial_seconds(arch, shape, 10, chips, overhead=30.0) == \
                want.trial_seconds(arch, shape, 10, chips, overhead=30.0)
            assert got.class_trial_seconds(arch, shape, 10, chips=chips, speed=2.5,
                                           overhead=7.0) == \
                want.class_trial_seconds(arch, shape, 10, chips=chips, speed=2.5,
                                         overhead=7.0)
    with pytest.raises(ValueError):
        got.class_trial_seconds(arch, "train_4k", 10, chips=1, speed=0.0)


def test_probe_path_reads_reference_layout(reference_constants):
    mesh_dir = reference_constants / "pod16x16"
    mesh_dir.mkdir()
    rec = {"compute_seconds": 0.010, "memory_seconds": 0.050,
           "collective_seconds": 0.002}
    (mesh_dir / "fake-arch__train_4k__default__probe.json").write_text(json.dumps(rec))
    cm = t_cm.CostModel()
    # the roofline max-term on REFERENCE_CHIPS cards, rescaled to 64
    assert cm.step_seconds("fake-arch", "train_4k", chips=64) == pytest.approx(0.050 * 4)
    t = cm.trial_seconds("fake-arch", "train_4k", steps=100, chips=256, overhead=30)
    assert t == pytest.approx(30 + 100 * 0.050)
    assert t == j_cm.CostModel().trial_seconds("fake-arch", "train_4k", steps=100,
                                               chips=256, overhead=30)


def test_observe_blends_as_reference(reference_constants):
    got, want = t_cm.CostModel(), j_cm.CostModel()
    arch, shape = "olmo-1b", "train_4k"
    for measured in (100.0, 50.0, 80.0):
        got.observe(arch, shape, 64, measured)
        want.observe(arch, shape, 64, measured)
        assert got._measured == want._measured
        assert got.trial_seconds(arch, shape, 10, chips=64) == \
            want.trial_seconds(arch, shape, 10, chips=64)
    assert got.trial_seconds(arch, shape, 10, chips=128) == \
        want.trial_seconds(arch, shape, 10, chips=128)


@pytest.mark.parametrize("arch,shape", [("qwen3-4b", "train_4k"),
                                        ("mamba2-1.3b", "long_500k")])
def test_device_class_from_cost_model_equals_reference(arch, shape, reference_constants):
    kw = dict(chips=64, speed=1.5, overhead=12.0, mem_gb=80.0)
    got = TDeviceClass.from_cost_model("h100x64", t_cm.CostModel(), arch, shape, 10, **kw)
    want = JDeviceClass.from_cost_model("h100x64", j_cm.CostModel(), arch, shape, 10, **kw)
    assert (got.name, got.chips, got.speed, got.overhead, got.mem_gb, got.chip_scale) == \
        (want.name, want.chips, want.speed, want.overhead, want.mem_gb, want.chip_scale)
    assert got.rate == want.rate
    assert np.array_equal(got.cost_on([10.0, 250.0]), want.cost_on([10.0, 250.0]))
