"""The port's data plane (models, configs, kernels 5 and 6) against the JAX
package's, on the CPU.

The two kernels' plain versions (``ops.flash_attention`` and
``ops.ssd_mix`` on CPU tensors) are held against the Pallas kernels run in
interpret mode and against the jnp references, on the sweeps of
``test_kernels.py``.  The models run the same weights: the reference's
parameters, initialised by ``jax.random``, are carried across with
``convert.model_params``, and the inputs are made with numpy from a seed.
The full-sequence forward is held against the reference's Pallas path
(``use_pallas=True``, and ``ssm.use_pallas=True`` for the SSD kernel).

Tolerances are those of ``test_kernels.py``: 2e-4 (absolute and relative)
in float32, where only the order of sums differs, and 5e-2 in bfloat16,
where the two frameworks round intermediate results at other places.  The
decode-after-prefill checks use ``test_models.py``'s 3e-2.
"""

import dataclasses
import math
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.sharding.rules import ParamSpec as JaxParamSpec  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.data import random_batch, split_last  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd as ssd_mod  # noqa: E402
from repro_torch.models import (  # noqa: E402
    ModelConfig,
    decode_step,
    forward_logits_last,
    forward_loss,
    init_cache,
    init_params,
    make_cache_specs,
    model_specs,
    prefill,
)
from repro_torch.models.moe import one_group  # noqa: E402
from repro_torch.models.spec import ParamSpec, tree_leaves  # noqa: E402

F32 = dict(atol=2e-4, rtol=2e-4)
BF16 = dict(atol=5e-2, rtol=5e-2)
DECODE = dict(atol=3e-2, rtol=3e-2)
DTYPES = {"float32": (jnp.float32, torch.float32, F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}


@pytest.fixture(autouse=True)
def cpu_path_never_launches():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    before = (flash_mod.launches, ssd_mod.launches)
    yield
    assert (flash_mod.launches, ssd_mod.launches) == before


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _both(a: np.ndarray, dtype: str):
    """The same values in both frameworks (bfloat16 rounded from the same
    float32 by both, to nearest even)."""
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


# --- kernel 5: flash attention ------------------------------------------------

@pytest.mark.parametrize("S,Hq,Hkv,D,window,dtype", [
    (128, 4, 4, 32, None, "float32"),     # MHA
    (256, 8, 2, 16, None, "float32"),     # GQA 4:1
    (128, 4, 1, 32, None, "float32"),     # MQA
    (256, 4, 2, 32, 64, "float32"),       # sliding window
    (128, 4, 2, 32, None, "bfloat16"),    # bf16
])
def test_flash_attention_plain_matches_pallas_and_ref(rng, S, Hq, Hkv, D, window, dtype):
    B = 2
    arrays = [rng.standard_normal((B, S, h, D)).astype(np.float32)
              for h in (Hq, Hkv, Hkv)]
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in arrays)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    assert got.dtype == tq.dtype and got.shape == (B, S, Hq, D)
    got = got.float().numpy()
    tol = DTYPES[dtype][2]
    pallas = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                  block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(got, _f32(pallas), **tol)
    np.testing.assert_allclose(
        got, _f32(jref.attention_ref(jq, jk, jv, causal=True, window=window)), **tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_takes_any_length(rng, causal):
    """S = 96 is no multiple of the Pallas kernel's 64 blocks: the port's
    function takes it, and equals the reference's jnp oracle."""
    q = rng.standard_normal((1, 96, 2, 16)).astype(np.float32)
    k = rng.standard_normal((1, 96, 1, 16)).astype(np.float32)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, k)),
                              causal=causal, window=40)
    want = jref.attention_ref(*(jnp.asarray(a) for a in (q, k, k)),
                              causal=causal, window=40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,causal", [
    (1, 2048, 4, 1, 128, None, True),     # GQA 4:1, qwen3's head dim, S 2,048
    (1, 1000, 4, 1, 120, 256, True),      # h2o's head dim, a window, ragged S
    (2, 300, 8, 2, 128, None, True),      # ragged S
    (1, 200, 4, 1, 120, 48, True),        # a window narrower than a tile
    (1, 130, 4, 1, 64, None, False),      # not causal
])
def test_bf16_rounding_of_p_fits_the_card_tolerance(rng, B, S, Hq, Hkv, D, window,
                                                     causal):
    """Rounding P once to bf16 before P V (the wgmma route's arithmetic
    before P was split, ``ref.attention_wgmma_route_ref(split_p=False)``)
    keeps the output within the card's bf16 tolerance of the float32
    oracles, the port's and the reference's: |got - want| <= 1e-2 |want| +
    1e-3 max |want|; so does the route's hi + lo P."""
    arrays = [rng.standard_normal((B, S, h, D)).astype(np.float32)
              for h in (Hq, Hkv, Hkv)]
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "bfloat16") for a in arrays)
    for split_p in (False, True):
        got = ref.attention_wgmma_route_ref(tq, tk, tv, causal=causal, window=window,
                                            split_p=split_p).float()
        for want in (ops.flash_attention(tq, tk, tv, causal=causal, window=window),
                     torch.from_numpy(np.array(_f32(jref.attention_ref(
                         jq, jk, jv, causal=causal, window=window))))):
            want = want.float()
            torch.testing.assert_close(got, want, rtol=1e-2,
                                       atol=1e-3 * float(want.abs().max()))


@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,causal", [
    (1, 2048, 4, 1, 128, None, True),     # qwen3's head dim, S 2,048
    (1, 1000, 4, 1, 120, 256, True),      # h2o's head dim, a window, ragged S
    (2, 300, 8, 2, 128, None, True),      # ragged S
    (1, 300, 2, 1, 256, 100, False),      # D 256 (64-key tiles), not causal
])
def test_wgmma_route_hi_lo_p_is_one_bf16_ulp_from_the_reference(rng, B, S, Hq, Hkv, D,
                                                                window, causal):
    """The bf16 flash route's arithmetic (``ref.attention_wgmma_route_ref``:
    P as bf16 hi + lo) against the reference's oracle, rounded to bf16 like
    it: rtol 2^-7 (two bf16 values one ulp apart are at most 2^-7 of the
    value apart) and an atol of 1e-4 of max |want| for values near 0.  The
    same arithmetic with P rounded once to bf16 misses that tolerance."""
    arrays = [rng.standard_normal((B, S, h, D)).astype(np.float32)
              for h in (Hq, Hkv, Hkv)]
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "bfloat16") for a in arrays)
    want = torch.from_numpy(np.array(_f32(jref.attention_ref(
        jq, jk, jv, causal=causal, window=window))))
    tol = dict(rtol=2**-7, atol=1e-4 * float(want.abs().max()))
    got = ref.attention_wgmma_route_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, **tol)
    once = ref.attention_wgmma_route_ref(tq, tk, tv, causal=causal, window=window,
                                         split_p=False)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(once.float(), want, **tol)


def _tf32_rna_exact(x: float) -> float:
    """x rounded to 10 fraction bits, to nearest, ties away from zero,
    computed on the value with fractions: the quantum is 2^(e - 11) for
    |x| = m 2^e (m in [0.5, 1)), and 2^-136 at least (the subnormals'
    grid); past the largest float32 the result is infinite."""
    if x == 0.0 or not math.isfinite(x):
        return x
    _, e = math.frexp(x)
    quantum = Fraction(2) ** max(e - 11, -136)
    val = math.floor(Fraction(abs(x)) / quantum + Fraction(1, 2)) * quantum
    return math.copysign(math.inf if val >= 2**128 else float(val), x)


@pytest.mark.parametrize("x", [
    pytest.param(1.0 + 2.0**-11, id="tie-up"),
    pytest.param(1.0 + 3 * 2.0**-11, id="tie-away"),
    pytest.param(-(1.0 + 2.0**-11), id="negative-tie"),
    pytest.param(1.0 + 2.0**-11 - 2.0**-23, id="below-tie"),
    pytest.param(2.0 - 2.0**-11, id="tie-into-next-binade"),
    pytest.param(2.0 - 2.0**-12, id="carry-into-exponent"),
    pytest.param(2.0**-126 * (1 + 2.0**-10), id="smallest-normals"),
    pytest.param(2.0**-127 + 2.0**-137, id="subnormal-tie"),
    pytest.param(2.0**-130 + 3 * 2.0**-149, id="subnormal"),
    pytest.param(3 * 2.0**-149, id="tiny-subnormal"),
    pytest.param(0.0, id="zero"),
    pytest.param(-0.0, id="negative-zero"),
    pytest.param(float(np.finfo(np.float32).max), id="overflow"),
    pytest.param(0.1, id="one-tenth"),
])
def test_tf32_split_rounds_like_cvt_rna(x):
    """``ref.tf32_split`` on the bit pattern (cvt.rna.tf32.f32's rounding)
    against the rounding computed on the value: hi = tf32(x) and lo =
    tf32(x - hi), bit for bit, signs of zero included; hi + lo within
    2^-21 of a normal x."""
    t = torch.tensor([x], dtype=torch.float32)
    hi, lo = (float(a) for a in ref.tf32_split(t))
    want_hi = _tf32_rna_exact(float(t))
    assert hi == want_hi and math.copysign(1.0, hi) == math.copysign(1.0, want_hi)
    if math.isfinite(want_hi):
        assert lo == _tf32_rna_exact(float(t) - hi)
        if abs(x) >= 2.0**-126:
            assert abs(hi + lo - float(t)) <= 2.0**-21 * abs(float(t))
    (once,) = ref.tf32_split(t, split=False)
    assert float(once) == want_hi


@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,causal", [
    (1, 256, 4, 1, 128, None, True),      # qwen3's head dim, GQA 4:1
    (2, 128, 4, 2, 64, 48, True),         # a window narrower than a tile
    (1, 128, 2, 1, 256, None, True),      # D 256 (32-key tiles)
    (1, 192, 4, 4, 80, None, True),       # D 80: padded to 128 on the card
    (1, 128, 4, 2, 32, None, False),      # not causal
])
def test_tf32x3_route_matches_pallas_and_ref(rng, B, S, Hq, Hkv, D, window, causal):
    """The float32 flash route's arithmetic (``ref.attention_tf32x3_route_ref``:
    each product as three TF32 products) against the reference's Pallas
    kernel in interpret mode and its jnp oracle, and against the port's
    oracle, at the float32 tolerance (2e-4); the same arithmetic with one
    TF32 product (each factor rounded once to tf32) misses it."""
    arrays = [rng.standard_normal((B, S, h, D)).astype(np.float32)
              for h in (Hq, Hkv, Hkv)]
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "float32") for a in arrays)
    got = ref.attention_tf32x3_route_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (B, S, Hq, D)
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  block_q=64, block_k=64, interpret=True)
    want = _f32(jref.attention_ref(jq, jk, jv, causal=causal, window=window))
    for other in (_f32(pallas), want,
                  ops.flash_attention(tq, tk, tv, causal=causal, window=window).numpy()):
        np.testing.assert_allclose(got.numpy(), other, **F32)
    once = ref.attention_tf32x3_route_ref(tq, tk, tv, causal=causal, window=window,
                                          split=False)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(once.numpy(), want, **F32)


# --- kernel 6: SSD ------------------------------------------------------------

@pytest.mark.parametrize("S,H,P,N,chunk,dtype", [
    (64, 2, 16, 8, 16, "float32"),
    (128, 4, 32, 16, 32, "float32"),
    (96, 3, 16, 8, 32, "float32"),
    (64, 2, 16, 8, 64, "float32"),        # single chunk
    (64, 2, 16, 8, 16, "bfloat16"),
])
def test_ssd_plain_matches_pallas_and_ref(rng, S, H, P, N, chunk, dtype):
    B = 2
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.1, (B, S, H)).astype(np.float32)
    la = np.broadcast_to(-dt * rng.uniform(0.5, 2.0, (1, 1, H)).astype(np.float32),
                         (B, S, H)).copy()
    b = rng.standard_normal((B, S, N)).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    (jx, tx), (jb, tb), (jc, tc) = (_both(a, dtype) for a in (x, b, c))
    tdt, tla = torch.from_numpy(dt), torch.from_numpy(la)
    got = ops.ssd_mix(tx, tdt, tla, tb, tc, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, P)
    # the inputs are the same values in both; the mix is float32 throughout
    pallas = jops.ssd_mix(jx, jnp.asarray(dt), jnp.asarray(la), jb, jc, chunk=chunk,
                          interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **F32)
    want = jref.ssd_ref(jx, jnp.asarray(dt), jnp.asarray(la), jb, jc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# the SSD output is float32 whatever the route: 2e-4 of each value and 2e-4
# of max |want| (chip_smoke.py's DATA_TOL for float32): the bf16 route's
# products keep about 16 bits a term (bf16 hi + lo), the float32 route's
# about 21 (tf32 hi + lo, three products), and their sums run in another
# order than the per-step recurrence's
def _data_tol_f32(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-4 * float(np.abs(want).max()))


def _ssd_case(rng, B, S, H, P, N):
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (B, S, H)).astype(np.float32)
    la = (-dt * rng.uniform(0.5, 2.0, (1, 1, H))).astype(np.float32)
    b = rng.standard_normal((B, S, N)).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, la, b, c


@pytest.mark.parametrize("S,H,P,N,chunk", [
    (128, 2, 32, 16, 32),       # mamba2-1.3b's smoke widths, four chunks
    (100, 2, 16, 8, 32),        # ragged last chunk (100 = 3 x 32 + 4)
    (96, 3, 40, 24, 96),        # a single chunk, Q = S = 96, P < 64
    (512, 2, 64, 128, 256),     # mamba2-1.3b's widths, two chunks
])
def test_ssd_chunked_route_matches_pallas_and_ref(rng, S, H, P, N, chunk):
    """``ref.ssd_chunked_ref`` (the tensor-core route's arithmetic) on bf16
    x, B and C against the reference's Pallas kernel in interpret mode
    (where the chunk divides S, as its grid needs) and its per-step oracle,
    and against the port's oracle ``ref.ssd_ref``."""
    B = 1
    x, dt, la, b, c = _ssd_case(rng, B, S, H, P, N)
    (jx, tx), (jb, tb), (jc, tc) = (_both(a, "bfloat16") for a in (x, b, c))
    tdt, tla = torch.from_numpy(dt), torch.from_numpy(la)
    got = ref.ssd_chunked_ref(tx, tdt, tla, tb, tc, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, P)
    got = got.numpy()
    if S % min(chunk, S) == 0:
        _data_tol_f32(got, np.asarray(jops.ssd_mix(jx, jnp.asarray(dt), jnp.asarray(la),
                                                   jb, jc, chunk=chunk, interpret=True)))
    _data_tol_f32(got, np.asarray(jref.ssd_ref(jx, jnp.asarray(dt), jnp.asarray(la),
                                               jb, jc)))
    _data_tol_f32(got, ref.ssd_ref(tx, tdt, tla, tb, tc).numpy())


def test_ssd_single_bf16_rounding_of_the_factors_misses_the_tolerance(rng):
    """At mamba2-1.3b's widths (Q 256, P 64, N 128; two chunks, two heads)
    the tensor-core route's arithmetic with each float32 factor (W', B', the
    carried state) rounded once to bf16 misses the float32 tolerance that
    the route is held to; with the hi + lo split it meets it."""
    x, dt, la, b, c = (torch.from_numpy(a) for a in _ssd_case(rng, 1, 512, 2, 64, 128))
    x, b, c = x.bfloat16(), b.bfloat16(), c.bfloat16()
    want = ref.ssd_ref(x, dt, la, b, c).numpy()
    _data_tol_f32(ref.ssd_chunked_ref(x, dt, la, b, c, chunk=256).numpy(), want)
    once = ref.ssd_chunked_ref(x, dt, la, b, c, chunk=256, split=False).numpy()
    with pytest.raises(AssertionError):
        _data_tol_f32(once, want)


@pytest.mark.parametrize("S,H,P,N,chunk", [
    (128, 2, 32, 16, 32),       # mamba2-1.3b's smoke widths, four chunks
    (100, 2, 16, 8, 32),        # ragged last chunk (100 = 3 x 32 + 4)
    (513, 1, 64, 128, 513),     # serve's check: one chunk, Q = S = 513, one head
    (512, 2, 64, 128, 256),     # mamba2-1.3b's widths, two chunks
])
def test_ssd_tf32x3_route_matches_pallas_and_ref(rng, S, H, P, N, chunk):
    """``ref.ssd_tf32x3_route_ref`` (the float32 route's arithmetic: every
    product as three TF32 products) on float32 x, B and C against the
    reference's Pallas kernel in interpret mode (where the chunk divides S),
    its per-step oracle, and the port's oracle ``ref.ssd_ref``."""
    B = 1
    x, dt, la, b, c = _ssd_case(rng, B, S, H, P, N)
    (jx, tx), (jb, tb), (jc, tc) = (_both(a, "float32") for a in (x, b, c))
    tdt, tla = torch.from_numpy(dt), torch.from_numpy(la)
    got = ref.ssd_tf32x3_route_ref(tx, tdt, tla, tb, tc, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, P)
    got = got.numpy()
    if S % min(chunk, S) == 0:
        _data_tol_f32(got, np.asarray(jops.ssd_mix(jx, jnp.asarray(dt), jnp.asarray(la),
                                                   jb, jc, chunk=chunk, interpret=True)))
    _data_tol_f32(got, np.asarray(jref.ssd_ref(jx, jnp.asarray(dt), jnp.asarray(la),
                                               jb, jc)))
    _data_tol_f32(got, ref.ssd_ref(tx, tdt, tla, tb, tc).numpy())


def test_ssd_single_tf32_product_misses_the_tolerance(rng):
    """At mamba2-1.3b's widths (Q 256, P 64, N 128; two chunks, two heads)
    the float32 route's arithmetic with each product taken once in TF32
    (each factor rounded once to tf32, 2^-11) misses the float32 tolerance
    that the route is held to; with three TF32 products it meets it."""
    x, dt, la, b, c = (torch.from_numpy(a) for a in _ssd_case(rng, 1, 512, 2, 64, 128))
    want = ref.ssd_ref(x, dt, la, b, c).numpy()
    _data_tol_f32(ref.ssd_tf32x3_route_ref(x, dt, la, b, c, chunk=256).numpy(), want)
    once = ref.ssd_tf32x3_route_ref(x, dt, la, b, c, chunk=256, split=False).numpy()
    with pytest.raises(AssertionError):
        _data_tol_f32(once, want)


# --- the models against the reference -----------------------------------------

def _jax_cfg(arch: str, dtype: str):
    """The reference's smoke config on its Pallas path, in ``dtype``."""
    cfg = jax_smoke_config(arch)
    ssm = cfg.ssm._replace(use_pallas=True) if cfg.ssm is not None else None
    return dataclasses.replace(cfg, use_pallas=True, ssm=ssm,
                               compute_dtype=DTYPES[dtype][0])


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _twins(arch: str, dtype: str, seed: int = 0):
    """(reference cfg, params) and (port cfg, the same params as tensors)."""
    jcfg = _jax_cfg(arch, dtype)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    tcfg = convert.model_config(_fields(jcfg))
    tparams = convert.model_params(jax.tree.map(np.asarray, jparams), "cpu")
    return (jcfg, jparams), (tcfg, tparams)


def _tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))


def _inputs(cfg, B, S, seed=0) -> dict:
    """``data.random_batch`` of S positions from ``seed``, with the labels
    of sequence 0's first 5 positions masked (-1)."""
    batch = random_batch(cfg, B, S, np.random.default_rng(seed))
    batch["labels"][0, :5] = -1
    return batch


def _jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch: dict, device="cpu") -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def _seq_len(arch: str) -> int:
    # past h2o-danube's smoke window (64), so the window masks
    return 96 if arch == "h2o-danube-3-4b" else 64


def _prefill_seq_len(arch: str) -> int:
    """S for the prefill-then-decode tests at B 2: a moe's prefill of S - 1
    positions must fill whole groups of its smoke group size, 32."""
    return 65 if jax_smoke_config(arch).moe is not None else _seq_len(arch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference_pallas_path(arch, dtype):
    (jcfg, jparams), (tcfg, tparams) = _twins(arch, dtype)
    assert tcfg.compute_dtype == DTYPES[dtype][1]
    batch = _inputs(tcfg, 2, _seq_len(arch))
    jbatch, tbatch = _jax(batch), _torch(batch)
    tol = DTYPES[dtype][2]

    got = forward_logits_last(tparams, tbatch, tcfg)
    want = jmodel.forward_logits_last(jparams, jbatch, jcfg, None)
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == tcfg.compute_dtype
    np.testing.assert_allclose(got.float().numpy(), _f32(want), **tol)

    loss = forward_loss(tparams, tbatch, tcfg)
    want_loss = jmodel.forward_loss(jparams, jbatch, jcfg, None)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(want_loss), **tol)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)
                                             if a.dtype == jnp.bfloat16 else a), tree)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_match_reference(arch):
    """prefill's last hidden state and cache, then one decode step's logits
    and cache, equal the reference's (float32)."""
    (jcfg, jparams), (tcfg, tparams) = _twins(arch, "float32", seed=1)
    S = _prefill_seq_len(arch)
    batch = _inputs(tcfg, 2, S, seed=1)
    head, tail = split_last(batch)
    jh, jcache = jmodel.prefill(jparams, _jax(head), jcfg, None, max_len=S + 8)
    th, tcache = prefill(tparams, _torch(head), tcfg, max_len=S + 8)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **F32)
    jtree, ttree = _np_tree(jcache), jax.tree.map(lambda t: t.numpy(), tcache)
    assert jax.tree.structure(jtree) == jax.tree.structure(ttree)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, a, **F32), jtree, ttree)

    jlog, jcache2 = jmodel.decode_step(jparams, _jax(tail), jcache, jcfg, None)
    tlog, tcache2 = decode_step(tparams, _torch(tail), tcache, tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **F32)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, a, **F32),
                 _np_tree(jcache2), jax.tree.map(lambda t: t.numpy(), tcache2))
    # the cache passed in is not modified
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(b, a), ttree,
                 jax.tree.map(lambda t: t.numpy(), tcache))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_prefill_and_decode_match_reference(arch):
    """The same in bfloat16, the configs' own dtype: the port's prefill and
    decode round where the reference's do (attention probabilities, the SSD
    products), so hidden state, logits and caches agree to BF16."""
    (jcfg, jparams), (tcfg, tparams) = _twins(arch, "bfloat16", seed=1)
    S = _prefill_seq_len(arch)
    batch = _inputs(tcfg, 2, S, seed=1)
    head, tail = split_last(batch)
    jh, jcache = jmodel.prefill(jparams, _jax(head), jcfg, None, max_len=S + 8)
    th, tcache = prefill(tparams, _torch(head), tcfg, max_len=S + 8)
    assert th.dtype == torch.bfloat16
    np.testing.assert_allclose(th.float().numpy(), _f32(jh), **BF16)
    jtree, ttree = _np_tree(jcache), _torch_np(tcache)
    assert jax.tree.structure(jtree) == jax.tree.structure(ttree)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, a, **BF16), jtree, ttree)
    jlog, jcache2 = jmodel.decode_step(jparams, _jax(tail), jcache, jcfg, None)
    tlog, tcache2 = decode_step(tparams, _torch(tail), tcache, tcfg)
    np.testing.assert_allclose(tlog.float().numpy(), _f32(jlog), **BF16)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, a, **BF16),
                 _np_tree(jcache2), _torch_np(tcache2))


def _torch_np(tree):
    return jax.tree.map(lambda t: t.float().numpy() if t.is_floating_point()
                        else t.numpy(), tree)


@pytest.mark.parametrize("arch,layers", [("qwen3-4b", 36), ("mamba2-1.3b", 48)])
def test_bf16_decode_drift_matches_reference_at_depth(arch, layers):
    """At the published depth (smoke widths) in bfloat16, decode after
    prefill drifts from the Pallas-path forward in the port as in the
    reference: the port's decode logits equal the reference's, and its
    forward logits the reference's, to BF16; both drifts stay within
    ``test_models.py``'s 3e-2 at these widths."""
    jcfg = dataclasses.replace(_jax_cfg(arch, "bfloat16"), num_layers=layers)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(1))
    tcfg = convert.model_config(_fields(jcfg))
    tparams = convert.model_params(jax.tree.map(np.asarray, jparams), "cpu")
    tokens, _ = _tokens(tcfg, 2, _seq_len(arch), seed=1)
    S = tokens.shape[1]
    jfwd = _f32(jmodel.forward_logits_last(jparams, {"tokens": jnp.asarray(tokens)},
                                           jcfg, None))
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :-1])},
                               jcfg, None, max_len=S + 8)
    jdec = _f32(jmodel.decode_step(jparams, {"tokens": jnp.asarray(tokens[:, -1:])},
                                   jcache, jcfg, None)[0])
    full = torch.from_numpy(tokens)
    tfwd = forward_logits_last(tparams, {"tokens": full}, tcfg).float().numpy()
    _, tcache = prefill(tparams, {"tokens": full[:, :-1]}, tcfg, max_len=S + 8)
    tdec = decode_step(tparams, {"tokens": full[:, -1:]}, tcache, tcfg)[0].float().numpy()
    np.testing.assert_allclose(tfwd, jfwd, **BF16)
    np.testing.assert_allclose(tdec, jdec, **BF16)
    np.testing.assert_allclose(jdec, jfwd, **DECODE)
    np.testing.assert_allclose(tdec, tfwd, **DECODE)


# --- the port on its own: decode after prefill == the kernel-path forward ------

def _kernel_route(cfg):
    """``cfg`` with the forward on the flash and SSD kernels."""
    ssm = cfg.ssm._replace(use_pallas=True) if cfg.ssm is not None else None
    return dataclasses.replace(cfg, use_pallas=True, ssm=ssm)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_matches_full_forward(arch):
    """decode(prefill(x[:S-1]), x[S-1]) logits == full forward logits at S
    (``test_models.py``'s case, in the configs' own bfloat16), the forward
    on the kernel route.  A moe at B 1 x S 129 (128 prefilled), one group
    a pass with a slot for every token (``one_group``)."""
    cfg = _kernel_route(get_smoke_config(arch))
    B, S = (1, 129) if cfg.moe is not None else (2, 48)
    cfg = one_group(cfg, B * S)
    params = init_params(cfg, 1, device="cpu")
    batch = _torch(_inputs(cfg, B, S))
    head, tail = split_last(batch)
    want = forward_logits_last(params, batch, cfg)
    _, cache = prefill(params, head, cfg, max_len=S + 8)
    got, _ = decode_step(params, tail, cache, cfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), **DECODE)


def test_hybrid_cache_is_nested_as_the_reference():
    """zamba2's cache: the Mamba2 states stacked (groups, k, ...), the
    shared block's KV stacked (groups, ...), in ``make_cache_specs``,
    ``init_cache`` and ``prefill`` alike, with the reference's shapes; the
    reference's prefill cache, carried across by ``convert.model_params``,
    decodes in the port to the reference's logits (float32)."""
    (jcfg, jparams), (tcfg, tparams) = _twins("zamba2-2.7b", "float32", seed=3)
    groups, k = tcfg.num_layers // tcfg.hybrid_attn_every, tcfg.hybrid_attn_every
    batch = _inputs(tcfg, 2, 40, seed=3)
    head, tail = split_last(batch)
    want = {p: v[0] for p, v in _shapes(jmodel.make_cache_specs(jcfg, 2, 48),
                                        JaxParamSpec).items()}
    assert {p: v[0] for p, v in _shapes(make_cache_specs(tcfg, 2, 48), ParamSpec).items()} \
        == want
    assert {p: v[0] for p, v in _shapes(init_cache(tcfg, 2, 48, device="cpu"),
                                        torch.Tensor).items()} == want
    _, cache = prefill(tparams, _torch(head), tcfg, max_len=48)
    assert {p: v[0] for p, v in _shapes(cache, torch.Tensor).items()} == want
    assert want[("ssm", "state")][:2] == (groups, k) and want[("attn", "k")][0] == groups
    _, jcache = jmodel.prefill(jparams, _jax(head), jcfg, None, max_len=48)
    carried = convert.model_params(jax.tree.map(np.asarray, jcache), "cpu")
    got, _ = decode_step(tparams, _torch(tail), carried, tcfg)
    jlog, _ = jmodel.decode_step(jparams, _jax(tail), jcache, jcfg, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(jlog), **F32)


def test_sliding_window_ring_buffer_decode():
    """With a sliding window, decoding past the window through the ring
    buffer matches the full forward (``test_models.py``'s case)."""
    cfg = _kernel_route(get_smoke_config("h2o-danube-3-4b"))   # window 64
    params = init_params(cfg, 2, device="cpu")
    tokens, _ = _tokens(cfg, 1, 96)                      # > window
    full = torch.from_numpy(tokens)
    want = forward_logits_last(params, {"tokens": full}, cfg)
    _, cache = prefill(params, {"tokens": full[:, :-1]}, cfg, max_len=104)
    assert cache["attn"]["k"].shape[2] == 64            # the cache holds one window
    got, _ = decode_step(params, {"tokens": full[:, -1:]}, cache, cfg)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), **DECODE)


def test_decode_from_an_empty_cache():
    """init_cache then decode_step: finite logits of the vocabulary's size,
    the length counters advanced, the cache's shapes kept."""
    for arch in ("qwen3-4b", "mamba2-1.3b"):
        cfg = get_smoke_config(arch)
        params = init_params(cfg, 0, device="cpu")
        cache = init_cache(cfg, 2, 96, device="cpu")
        logits, cache2 = decode_step(params, {"tokens": torch.ones((2, 1), dtype=torch.int32)},
                                     cache, cfg)
        assert logits.shape == (2, 1, cfg.vocab_size) and torch.isfinite(logits).all()
        key = "ssm" if cfg.family == "ssm" else "attn"
        assert cache2[key]["length"].tolist() == [1] * cfg.num_layers
        assert {k: v.shape for k, v in cache2[key].items()} == \
            {k: v.shape for k, v in cache[key].items()}


# --- configs and specs ----------------------------------------------------------

def _shapes(specs, leaf_type):
    out = {}

    def walk(t, path):
        if isinstance(t, leaf_type):
            out[path] = (tuple(t.shape), getattr(t, "logical_axes", None))
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
    walk(specs, ())
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_and_param_count_match_reference(arch):
    """Every full and smoke config: the same parameter tree (key paths,
    shapes, logical axes), ``param_count``, ``active_param_count`` and
    attention layers as the reference, from the specs alone."""
    for port, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch))):
        assert _shapes(model_specs(port), ParamSpec) == \
            _shapes(jmodel.model_specs(ref), JaxParamSpec)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        assert (port.uses_attention, port.num_attn_layers) == \
            (ref.uses_attention, ref.num_attn_layers)
        for f in dataclasses.fields(port):
            if f.name not in ("compute_dtype", "param_dtype", "ssm", "moe"):
                assert getattr(port, f.name) == getattr(ref, f.name), f.name
        for f in ("ssm", "moe"):
            want = getattr(ref, f)
            assert (getattr(port, f) is None) == (want is None), f
            if want is not None:   # less the reference's lax.scan unroll
                assert getattr(port, f)._asdict() == \
                    {k: v for k, v in want._asdict().items() if k != "unroll"}, f
                if f == "moe":
                    assert port.moe.capacity == want.capacity


def test_init_params_shapes_and_dtypes():
    cfg = get_smoke_config("qwen3-8b")
    params = init_params(cfg, 3, device="cpu")
    assert _shapes(params, torch.Tensor).keys() == _shapes(model_specs(cfg), ParamSpec).keys()
    for t, s in zip(tree_leaves(params, lambda x: isinstance(x, torch.Tensor)),
                    tree_leaves(model_specs(cfg))):
        assert tuple(t.shape) == s.shape and t.dtype == torch.float32
    # a seed and a generator seeded alike draw the same parameters
    again = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(params["blocks"]["attn"]["wq"], again["blocks"]["attn"]["wq"])
    assert torch.equal(params["blocks"]["attn"]["q_norm"]["scale"],
                       torch.ones_like(params["blocks"]["attn"]["q_norm"]["scale"]))


def test_arch_ids_are_the_references():
    """Every architecture of the reference is ported, in its order; an
    unknown one raises ``KeyError``."""
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    assert ARCH_IDS == JAX_ARCH_IDS
    for fn in (get_config, get_smoke_config):
        with pytest.raises(KeyError):
            fn("no-such-model")


def test_model_config_maps_the_reference_fields():
    jcfg = _jax_cfg("mamba2-1.3b", "bfloat16")
    tcfg = convert.model_config(_fields(jcfg))
    assert isinstance(tcfg, ModelConfig)
    assert tcfg.compute_dtype == torch.bfloat16 and tcfg.param_dtype == torch.float32
    assert tcfg.ssm == get_smoke_config("mamba2-1.3b").ssm._replace(use_pallas=True)
    assert tcfg.use_pallas and tcfg.ssm.use_pallas and tcfg.remat == jcfg.remat
    cache = jmodel.init_cache(jcfg, 2, 16)
    tcache = convert.model_params(jax.tree.map(np.asarray, cache), "cpu")
    assert tcache["ssm"]["conv"].dtype == torch.bfloat16
    assert tcache["ssm"]["length"].dtype == torch.int32


# --- devices and wrappers ---------------------------------------------------------

def test_entry_points_need_a_device(monkeypatch):
    """device=None means the card: without one, every entry point raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("qwen3-4b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 16)
    from repro_torch.serve import StaticBatchEngine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StaticBatchEngine(cfg, init_params(cfg, 0, device="cpu"))
