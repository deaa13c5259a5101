"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's, on the CPU.

The same router and expert weights and inputs, made with numpy from a
seed, go through both.  The router's expert ids equal the reference's
exactly in float32 (a stable descending sort takes the lower id first of
equal probabilities, as ``jax.lax.top_k`` does), and each pick's slot and
keep mask equal a plain loop over the group's tokens in order.  Outputs
hold to ``test_torch_models.py``'s tolerances: 2e-4 in float32, 5e-2 in
bfloat16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import moe  # noqa: E402

F32 = dict(atol=2e-4, rtol=2e-4)
BF16 = dict(atol=5e-2, rtol=5e-2)
DTYPES = {"float32": (jnp.float32, torch.float32, F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}


def _cfgs(**kw):
    """(the reference's MoEConfig, the port's) with the same fields."""
    fields = dict(d_model=64, d_ff=96, num_experts=8, top_k=2, group_size=32) | kw
    return jmoe.MoEConfig(**fields), moe.MoEConfig(**fields)


def _params(cfg, seed: int, skew: float = 0.0) -> dict:
    """Router and expert weights as numpy arrays; ``skew`` adds a column to
    the router that the inputs' shared direction (see ``_inputs``) drives,
    so that expert 0 tops every token's list."""
    rng = np.random.default_rng(seed)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": rng.standard_normal((d, E)) / np.sqrt(d),
         "wi_gate": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "wi_up": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "wo": rng.standard_normal((E, f, d)) / np.sqrt(f)}
    p["router"][:, 0] += skew / np.sqrt(d)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _inputs(B: int, S: int, d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, d)) + 1.0).astype(np.float32)


def _both(tree: dict, dtype: str):
    jdt, tdt, _ = DTYPES[dtype]
    return ({k: jnp.asarray(v, jdt) for k, v in tree.items()},
            {k: torch.from_numpy(v).to(tdt) for k, v in tree.items()})


def _slots(ids: np.ndarray, C: int):
    """The oracle of ``dispatch``: each group's picks in (token, k) order,
    each taking its expert's next slot; kept while the slot is < C."""
    pos = np.zeros(ids.shape, np.int64)
    for g in range(ids.shape[0]):
        taken: dict[int, int] = {}
        for s in range(ids.shape[1]):
            for k in range(ids.shape[2]):
                e = int(ids[g, s, k])
                pos[g, s, k] = taken.get(e, 0)
                taken[e] = pos[g, s, k] + 1
    return pos, pos < C


@pytest.mark.parametrize("top_k,skew", [(2, 0.0), (4, 0.0), (2, 8.0)])
def test_route_ids_and_keep_masks_equal_reference(top_k, skew):
    """float32: the same expert ids as the reference's ``_route``, gates and
    aux loss to F32; the slots and keep masks of every pick equal the plain
    loop's; with a skewed router, expert 0 overflows its capacity."""
    jcfg, tcfg = _cfgs(top_k=top_k)
    p = _params(tcfg, 0, skew)
    x = _inputs(4, 32, tcfg.d_model, 1)                   # 4 groups of 32
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jg, jids, jaux = jmoe._route(jnp.asarray(p["router"]), jx, jcfg)
    tg, tids, taux = moe._route(torch.from_numpy(p["router"]), tx, tcfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **F32)
    np.testing.assert_allclose(float(taux), float(jaux), **F32)
    pos, keep = moe.dispatch(tids, tcfg, tcfg.capacity)
    want_pos, want_keep = _slots(tids.numpy(), tcfg.capacity)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if skew:                           # every token's first pick is expert 0
        assert (tids[..., 0] == 0).all() and tcfg.capacity < 32
        assert (keep[..., 0].sum(1) == tcfg.capacity).all()


def test_route_ties_take_the_lower_expert():
    """Equal router probabilities (a zero router: all experts tie) pick the
    lowest ids first, in the reference as in the port."""
    jcfg, tcfg = _cfgs(top_k=3)
    x = _inputs(1, 32, tcfg.d_model, 2)
    _, jids, _ = jmoe._route(jnp.zeros((64, 8)), jnp.asarray(x), jcfg)
    _, tids, _ = moe._route(torch.zeros((64, 8)), torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert (tids.numpy() == np.array([0, 1, 2])).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k,skew", [(2, 0.0), (4, 0.0), (2, 8.0)])
def test_moe_apply_matches_reference(dtype, top_k, skew):
    """Output and aux loss of ``moe_apply``, 2 x 64 tokens in groups of 32;
    with the skewed router one expert drops tokens past its capacity."""
    jcfg, tcfg = _cfgs(top_k=top_k)
    jp, tp = _both(_params(tcfg, 3, skew), "float32")    # float32 weights
    x = _inputs(2, 64, tcfg.d_model, 4)
    jx, tx = _both({"x": x}, dtype)
    jy, jaux = jmoe.moe_apply(jp, jx["x"], jcfg, None)
    ty, taux = moe.moe_apply(tp, tx["x"], tcfg)
    assert ty.dtype == DTYPES[dtype][1] and ty.shape == (2, 64, 64)
    assert taux.dtype == torch.float32 and taux.shape == ()
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(float(taux), float(jaux), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_decode_matches_reference(dtype):
    """One token for each of 6 sequences: one group of 6, its capacity from
    group_size 6 (3 slots an expert at top 2 of 8)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _both(_params(tcfg, 5), "float32")
    x = _inputs(6, 1, tcfg.d_model, 6)
    jx, tx = _both({"x": x}, dtype)
    got = moe.moe_decode(tp, tx["x"], tcfg)
    want = jmoe.moe_decode(jp, jx["x"], jcfg, None)
    assert got.shape == (6, 1, 64) and tcfg._replace(group_size=6).capacity == 3
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **DTYPES[dtype][2])


def test_group_that_does_not_divide_raises():
    """The reference asserts that the group divides the tokens; the port
    raises ValueError on the same condition."""
    _, tcfg = _cfgs()
    tp = {k: torch.from_numpy(v) for k, v in _params(tcfg, 0).items()}
    with pytest.raises(ValueError, match="must divide group size 32"):
        moe.moe_apply(tp, torch.zeros((2, 40, 64)), tcfg)      # 80 tokens
    y, _ = moe.moe_apply(tp, torch.zeros((1, 20, 64)), tcfg)  # 20 < 32: one group
    assert y.shape == (1, 20, 64)


def test_capacity_matches_reference():
    for kw in (dict(), dict(top_k=8, num_experts=128, group_size=128),
               dict(top_k=2, num_experts=128, group_size=128), dict(group_size=1)):
        jcfg, tcfg = _cfgs(**kw)
        assert tcfg.capacity == jcfg.capacity
    assert _cfgs(top_k=8, num_experts=128, group_size=128)[1].capacity == 16
    assert _cfgs(top_k=2, num_experts=128, group_size=128)[1].capacity == 4
