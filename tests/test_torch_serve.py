"""The port's serving engine: waves, stopping, utilisation, and the same
tokens as the reference's engine.

``test_serve.py``'s cases run on the port (CPU), and the port's engine is
held to the reference's on the qwen3-4b smoke config: the reference's
parameters, carried across with ``convert.model_params``, and the same
requests give the same output tokens (greedy argmax, so equal tokens, not
a tolerance) and the same counters.  That comparison runs in float32: in
the config's bfloat16 the two frameworks' logits differ by one bfloat16
ulp (3.9e-3 at 0.5), and the smoke model's top two logits come that close
(request 4's second token below), so an exact-token check would test
bfloat16 rounding, not the engine.  The bfloat16 logits are held to 5e-2
in ``test_torch_models.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import StaticBatchEngine as JaxEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve import Request, ServeConfig, StaticBatchEngine  # noqa: E402


@pytest.fixture(scope="module")
def engine():
    cfg = get_smoke_config("qwen3-4b")
    params = init_params(cfg, 0, device="cpu")
    return StaticBatchEngine(cfg, params, ServeConfig(batch_slots=2, max_len=128),
                             device="cpu")


def test_engine_serves_all_requests(engine):
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, 255, size=8 + i).astype(np.int32),
                    max_new_tokens=4) for i in range(5)]
    for r in reqs:
        engine.submit(r)
    done = engine.run()
    assert len(done) == 5
    assert all(r.done and len(r.output) == 4 for r in done)
    assert engine.stats["waves"] == 3           # 2 + 2 + 1 slots
    assert engine.stats["decode_steps"] == 12 and engine.slot_utilization == 1.0
    assert 0.0 < engine.stats["prefill"] <= engine.stats["wall"]


def test_engine_eos_stops_early():
    cfg = get_smoke_config("qwen3-4b")
    params = init_params(cfg, 0, device="cpu")
    eng = StaticBatchEngine(cfg, params, ServeConfig(batch_slots=1, max_len=128),
                            device="cpu")
    probe = Request(0, np.arange(8, dtype=np.int32), max_new_tokens=1)
    eng.submit(probe)
    eng.run()
    first = probe.output[0]
    # same prompt with that token as EOS stops after one step
    r = Request(1, np.arange(8, dtype=np.int32), max_new_tokens=16, eos_id=first)
    eng.submit(r)
    eng.run()
    assert len(r.output) == 1 and r.output[0] == first
    assert 0.0 < eng.slot_utilization <= 1.0


def _requests(cls, seed=0):
    rng = np.random.default_rng(seed)
    # ragged prompts (left padding), ragged budgets (slots idle), one EOS
    lens, budgets = (5, 12, 9, 16, 7), (6, 3, 6, 5, 4)
    return [cls(i, rng.integers(0, 255, size=n).astype(np.int32), max_new_tokens=m,
                eos_id=(17 if i == 3 else None))
            for i, (n, m) in enumerate(zip(lens, budgets))]


def test_engine_tokens_equal_reference():
    """The same weights and requests: the port's engine emits the
    reference's tokens, wave by wave, with the same counters (float32)."""
    jcfg = dataclasses.replace(jax_smoke_config("qwen3-4b"), compute_dtype=jnp.float32)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.model_params(jax.tree.map(np.asarray, jparams), "cpu")
    tcfg = dataclasses.replace(get_smoke_config("qwen3-4b"), compute_dtype=torch.float32)

    ref = JaxEngine(jcfg, jparams, JaxServeConfig(batch_slots=2, max_len=128))
    port = StaticBatchEngine(tcfg, tparams, ServeConfig(batch_slots=2, max_len=128),
                             device="cpu")
    ref_reqs, port_reqs = _requests(JaxRequest), _requests(Request)
    for r in ref_reqs:
        ref.submit(r)
    for r in port_reqs:
        port.submit(r)
    want = {r.request_id: r.output for r in ref.run()}
    got = {r.request_id: r.output for r in port.run()}
    assert got == want
    for key in ("waves", "decode_steps", "slot_steps_used", "slot_steps_total"):
        assert port.stats[key] == ref.stats[key], key
    assert port.slot_utilization == ref.slot_utilization < 1.0


def test_engine_refuses_parameters_elsewhere():
    cfg = get_smoke_config("qwen3-4b")
    params = init_params(cfg, 0, device="cpu")
    params["embed"]["table"] = params["embed"]["table"].to("meta")
    with pytest.raises(ValueError, match="parameter is on meta"):
        StaticBatchEngine(cfg, params, device="cpu")
