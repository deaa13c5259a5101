"""The port's serving engine: waves, stopping, utilisation, and the same
tokens as the reference's engine.

``test_serve.py``'s cases run on the port (CPU), and the port's engine is
held to the reference's on the qwen3-4b smoke config: the reference's
parameters, carried across with ``convert.model_params``, and the same
requests give the same output tokens (greedy argmax, so equal tokens, not
a tolerance) and the same counters.  In float32 against the reference's
engine as it runs.  In the config's bfloat16 against the reference's
engine where XLA rounds every op as the reference's source says
(``--xla_allow_excess_precision=false``, in a subprocess: the flag is read
when XLA starts).  By default XLA's compiled programs (a jitted decode
step, scanned layer bodies) keep some fused bfloat16 intermediates in
float32; the logits then differ from the port's by one bfloat16 ulp past
layer 0, and request 4's second token, two logits within that ulp, flips.
Run op by op the two depart at one op only, the MLP's SiLU: XLA expands
``jax.nn.silu``'s logistic into 1 / (1 + exp(-x)) and rounds each step,
and the product, to bfloat16, where ``F.silu`` rounds once.  With the SiLU
rounded that way (``_silu_as_xla``, here only) the port's prefill equals
the reference's bit for bit.  The port keeps ``F.silu``: the four-step
rounding is less accurate (it takes the port's own bfloat16
decode-after-prefill on the qwen3-8b smoke model past
``test_torch_models``' 3e-2), costs four more elementwise passes over the
MLP's gate on the card, and changes no token here.
"""

import dataclasses
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import StaticBatchEngine as JaxEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import init_params, layers, prefill  # noqa: E402
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


def _request_args():
    """:func:`_requests`' (id, prompt, budget, eos) as plain lists."""
    return [(r.request_id, r.tokens.tolist(), r.max_new_tokens, r.eos_id)
            for r in _requests(Request)]


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


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "qwen3-moe-235b-a22b", "arctic-480b"])
def test_engine_serves_hybrid_and_moe_as_reference(arch):
    """The hybrid and the two moe configs (smoke widths, float32): the
    port's engine emits the reference's tokens with the same counters.  The
    waves hold 24, 32 and 7 prompt tokens: each a whole group of the moe's
    32, or fewer (one group)."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), compute_dtype=jnp.float32)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.model_params(jax.tree.map(np.asarray, jparams), "cpu")
    tcfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=torch.float32)
    ref = JaxEngine(jcfg, jparams, JaxServeConfig(batch_slots=2, max_len=128))
    port = StaticBatchEngine(tcfg, tparams, ServeConfig(batch_slots=2, max_len=128),
                             device="cpu")
    for r in _requests(JaxRequest):
        ref.submit(r)
    for r in _requests(Request):
        port.submit(r)
    want = {r.request_id: r.output for r in ref.run()}
    assert {r.request_id: r.output for r in port.run()} == want
    for key in ("waves", "decode_steps", "slot_steps_used", "slot_steps_total"):
        assert port.stats[key] == ref.stats[key], key


def test_moe_wave_that_splits_a_group_raises():
    """A moe wave of 2 x 20 prompt tokens: 40 is no multiple of the smoke
    group (32), which the reference asserts and the port raises on."""
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    eng = StaticBatchEngine(cfg, init_params(cfg, 0, device="cpu"),
                            ServeConfig(batch_slots=2, max_len=64), device="cpu")
    for i in range(2):
        eng.submit(Request(i, np.arange(20, dtype=np.int32), max_new_tokens=2))
    with pytest.raises(ValueError, match="must divide group size 32"):
        eng.run()


def test_serve_decode_example():
    """The serving demo on the CPU against the reference: paligemma prefills
    its 16 patches and the 12-token prompts, then decodes 6 tokens a
    sequence; the reference's ``prefill`` and ``decode_step``, given the
    demo's parameters, prompts and cache size, decode the same greedy
    tokens (the configs' bfloat16, run op by op).  The demo's cache also
    holds the patches (16 + 12 + 6 + 8 positions); the reference's example
    sizes it for the prompt and the new tokens only (26 positions for 28
    prefilled), so its decode steps see a ring buffer that has dropped the
    oldest patches, and there sequence 1's greedy tokens depart from the
    demo's from the third on.  musicgen (frames) is refused."""
    from repro_torch.examples import serve_decode
    from repro_torch.models.spec import tree_map
    out = serve_decode.main(["--arch", "paligemma-3b", "--device", "cpu", "--batch", "2",
                             "--prompt-len", "12", "--new-tokens", "6"])
    prompts = out["prompts"]
    assert out["tokens"].shape == (2, 6) and prompts["patches"].shape == (2, 16, 48)
    jcfg = jax_smoke_config("paligemma-3b")
    jparams = tree_map(lambda t: jnp.asarray(t.float().numpy()), out["params"],
                       lambda x: isinstance(x, torch.Tensor))
    jprompts = {k: jnp.asarray(v.numpy()) for k, v in prompts.items()}

    def reference_tokens(max_len):
        _, cache = jax_model.prefill(jparams, jprompts, jcfg, None, max_len=max_len)
        tok, toks = jprompts["tokens"][:, -1:], []
        for _ in range(6):
            logits, cache = jax_model.decode_step(jparams, {"tokens": tok}, cache, jcfg,
                                                  None)
            tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
            toks.append(np.asarray(tok[:, 0]))
        return np.stack(toks, axis=1)

    assert out["max_len"] == 16 + 12 + 6 + 8
    np.testing.assert_array_equal(reference_tokens(out["max_len"]), out["tokens"])
    assert not np.array_equal(reference_tokens(12 + 6 + 8), out["tokens"])
    with pytest.raises(SystemExit, match="token-input"):
        serve_decode.main(["--arch", "musicgen-medium", "--device", "cpu"])


def _silu_as_xla(x):
    """x * sigmoid(x) rounded as XLA's expansion of ``jax.nn.silu`` rounds
    it: exp(-x), 1 + exp(-x), its reciprocal and the product, each to x's
    dtype."""
    return x * torch.reciprocal(1.0 + torch.exp(-x))


def _port_bf16_tokens():
    """The port's engine on the qwen3-4b smoke config in bfloat16, with the
    reference's parameters (``PRNGKey(0)``)."""
    jparams = jax_init_params(jax_smoke_config("qwen3-4b"), jax.random.PRNGKey(0))
    tparams = convert.model_params(jax.tree.map(np.asarray, jparams), "cpu")
    cfg = get_smoke_config("qwen3-4b")
    assert cfg.compute_dtype == torch.bfloat16
    port = StaticBatchEngine(cfg, tparams, ServeConfig(batch_slots=2, max_len=128),
                             device="cpu")
    for r in _requests(Request):
        port.submit(r)
    return {str(r.request_id): r.output for r in port.run()}, port.stats


_REFERENCE_ENGINE = """
import json
import jax, numpy as np
from repro.configs import get_smoke_config
from repro.models import init_params
from repro.serve import Request, ServeConfig, StaticBatchEngine
cfg = get_smoke_config("qwen3-4b")
eng = StaticBatchEngine(cfg, init_params(cfg, jax.random.PRNGKey(0)),
                        ServeConfig(batch_slots=2, max_len=128))
for i, toks, budget, eos in {requests!r}:
    eng.submit(Request(i, np.asarray(toks, np.int32), max_new_tokens=budget, eos_id=eos))
out = {{r.request_id: r.output for r in eng.run()}}
print(json.dumps({{"tokens": out, "stats": eng.stats}}))
"""


def test_engine_tokens_equal_reference_bf16(monkeypatch):
    """The config's bfloat16, the reference's engine where XLA rounds every
    op as its source says (excess precision off): the port's engine emits
    the same tokens, wave by wave, with the same counters, and so it does
    with the SiLU rounded as XLA rounds it."""
    root = Path(__file__).resolve().parents[1]
    code = _REFERENCE_ENGINE.format(requests=_request_args())
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        env={"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_allow_excess_precision=false"},
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    got, stats = _port_bf16_tokens()
    assert got == ref["tokens"]
    for key in ("waves", "decode_steps", "slot_steps_used", "slot_steps_total"):
        assert stats[key] == ref["stats"][key], key
    monkeypatch.setitem(layers._ACTIVATIONS, "silu", _silu_as_xla)
    assert _port_bf16_tokens()[0] == ref["tokens"]


def test_bf16_first_departing_op_is_the_mlp_silu(monkeypatch):
    """Where the port departs from the reference in bfloat16.  The SiLU
    alone: run op by op, ``jax.nn.silu`` equals ``_silu_as_xla`` bit for bit
    and ``F.silu`` does not.  The prefill of one wave: with the SiLU rounded
    as XLA rounds it, the port equals the reference run op by op
    (``jax.disable_jit``) bit for bit, hidden state and every layer's cache;
    with ``F.silu`` layer 0's keys and values still agree and layer 1's do
    not (the departure is layer 0's MLP).  The reference's default compiled
    prefill departs from the former past layer 0's keys and values too
    (XLA's excess precision)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(
        np.float32)).bfloat16()
    with jax.disable_jit():
        jx = np.asarray(jnp.asarray(jax.nn.silu(jnp.asarray(x.float().numpy(), jnp.bfloat16)),
                                    jnp.float32))
    assert np.array_equal(jx, _silu_as_xla(x).float().numpy())
    assert not np.array_equal(jx, torch.nn.functional.silu(x).float().numpy())

    jcfg = jax_smoke_config("qwen3-4b")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.model_params(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.stack([np.pad(t.tokens, (12 - len(t.tokens), 0))
                       for t in _requests(Request)[1:3]])          # one wave

    def f32(a):
        return np.asarray(jnp.asarray(a, jnp.float32))

    def port_prefill():
        return prefill(tparams, {"tokens": torch.from_numpy(tokens)},
                       get_smoke_config("qwen3-4b"), max_len=24)

    def same(jcache, tcache, layer):
        return all(np.array_equal(f32(jcache["attn"][key][layer]),
                                  tcache["attn"][key][layer].float().numpy())
                   for key in ("k", "v"))

    with jax.disable_jit():
        jh, jcache = jax_model.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg,
                                       None, max_len=24)
    th, tcache = port_prefill()
    assert same(jcache, tcache, 0) and not same(jcache, tcache, 1)
    monkeypatch.setitem(layers._ACTIVATIONS, "silu", _silu_as_xla)
    th, tcache = port_prefill()
    assert np.array_equal(f32(jh), th.float().numpy())
    assert all(same(jcache, tcache, layer) for layer in range(jcfg.num_layers))
    jh, jcache = jax_model.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg,
                                   None, max_len=24)
    assert same(jcache, tcache, 0) and not same(jcache, tcache, 1)


@pytest.mark.parametrize("length", [5, 21])
def test_attention_decode_without_write_back_equals_reference(length):
    """``attention_decode(write_back=False)``, the cache-in-carry branch, on
    layer 0 of the qwen3-4b smoke config (float32) with a 16-slot cache,
    before the ring wraps (length 5) and after (21, slot 5): the output
    equals the reference's branch within float32 2e-5, the returned cache
    is the new token's (B, 1, Hkv, D) projections (the reference's, within
    2e-5), and the output equals the port's ``write_back=True`` step on the
    same cache, whose written slot holds those projections."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    jcfg = dataclasses.replace(jax_smoke_config("qwen3-4b"), compute_dtype=jnp.float32)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda a: np.asarray(a)[0], jparams["blocks"]["attn"])
    tp = convert.model_params(jp, "cpu")
    acfg = jcfg.attn_cfg
    tcfg = get_smoke_config("qwen3-4b").attn_cfg
    rng = np.random.default_rng(length)
    B, size = 2, 16
    shape = (B, size, acfg.num_kv_heads, acfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    x = rng.standard_normal((B, 1, acfg.d_model)).astype(np.float32)

    jy, jc = jattn.attention_decode(
        jp, jnp.asarray(x), jattn.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.int32(length)),
        acfg, None, write_back=False)
    cache = tattn.KVCache(torch.from_numpy(k), torch.from_numpy(v),
                          torch.tensor(length, dtype=torch.int32))
    y, c = tattn.attention_decode(tp, torch.from_numpy(x), cache, tcfg, write_back=False)
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tol)
    assert c.k.shape == c.v.shape == (B, 1, acfg.num_kv_heads, acfg.head_dim)
    np.testing.assert_allclose(c.k.numpy(), np.asarray(jc.k), **tol)
    np.testing.assert_allclose(c.v.numpy(), np.asarray(jc.v), **tol)
    assert int(c.length) == int(jc.length) == length + 1

    y_wb, c_wb = tattn.attention_decode(tp, torch.from_numpy(x), cache, tcfg)
    np.testing.assert_allclose(y.numpy(), y_wb.numpy(), **tol)
    slot = length % size
    torch.testing.assert_close(c_wb.k[:, slot:slot + 1], c.k, rtol=0, atol=0)
    torch.testing.assert_close(c_wb.v[:, slot:slot + 1], c.v, rtol=0, atol=0)


@pytest.mark.parametrize("length", [5, 21])
def test_attention_decode_without_write_back_equals_reference_bf16(length):
    """The same branch in the config's bfloat16 (the cache, the input and
    the output in bfloat16, float32 parameters cast at use), before the ring
    wraps and after: the output and the returned new-token projections
    equal the reference's branch bit for bit, the reference run op by op
    (as ``attention_decode`` is called, outside ``jit``, whose fusions
    keep some bfloat16 intermediates in float32: the module docstring)."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    jcfg = jax_smoke_config("qwen3-4b")
    assert jcfg.compute_dtype == jnp.bfloat16
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda a: np.asarray(a)[0], jparams["blocks"]["attn"])
    tp = convert.model_params(jp, "cpu")
    acfg = jcfg.attn_cfg
    tcfg = get_smoke_config("qwen3-4b").attn_cfg
    rng = np.random.default_rng(length)
    B, size = 2, 16
    shape = (B, size, acfg.num_kv_heads, acfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    x = rng.standard_normal((B, 1, acfg.d_model)).astype(np.float32)

    jk, jv, jx = (jnp.asarray(a, jnp.bfloat16) for a in (k, v, x))
    jy, jc = jattn.attention_decode(jp, jx, jattn.KVCache(jk, jv, jnp.int32(length)),
                                    acfg, None, write_back=False)
    tk, tv, tx = (torch.from_numpy(a).to(torch.bfloat16) for a in (k, v, x))
    cache = tattn.KVCache(tk, tv, torch.tensor(length, dtype=torch.int32))
    y, c = tattn.attention_decode(tp, tx, cache, tcfg, write_back=False)
    assert y.dtype == c.k.dtype == c.v.dtype == torch.bfloat16
    for got, want in ((y, jy), (c.k, jc.k), (c.v, jc.v)):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert int(c.length) == int(jc.length) == length + 1


def test_engine_refuses_parameters_elsewhere():
    cfg = get_smoke_config("qwen3-4b")
    params = init_params(cfg, 0, device="cpu")
    params["embed"]["table"] = params["embed"]["table"].to("meta")
    with pytest.raises(ValueError, match="parameter is on meta"):
        StaticBatchEngine(cfg, params, device="cpu")
