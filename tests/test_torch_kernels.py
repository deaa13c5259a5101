"""The port's kernel entry points against the JAX package's kernels.

On the CPU the port's ``ops`` take the plain PyTorch versions; each is held
against the Pallas kernel run in interpret mode and against its jnp
reference, on the shape sweeps of ``test_kernels.py``.  The tolerance is
that file's (1e-4 for EIrate, 2e-4 for the readout): the Pallas kernel
takes Phi from erf, the port (like the reference's decision path) from
ndtr, and the two sum in different orders.  The CUDA kernels are held
against the plain versions on the card in ``test_torch_cuda.py``.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import _build  # noqa: E402
from repro_torch.kernels import ei_score, gp_readout, ops, ref, tma  # noqa: E402


@pytest.fixture(autouse=True)
def cpu_path_never_launches():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    before = (ei_score.launches, ei_score.topk_launches, gp_readout.launches)
    yield
    assert (ei_score.launches, ei_score.topk_launches,
            gp_readout.launches) == before


def _ei_inputs(rng, n, N, layout="random"):
    """``"random"``: 40% membership; ``"disjoint"``: one owner a model, the
    paper's workloads (owners in ascending blocks, as the planes lay out
    their tenants)."""
    mu = rng.standard_normal(n).astype(np.float32)
    sg = np.abs(rng.standard_normal(n)).astype(np.float32)
    sg[: n // 4] = 0.0                                  # degenerate sigmas
    best = rng.standard_normal(N).astype(np.float32)
    if layout == "disjoint":
        mem = np.zeros((N, n), bool)
        mem[np.arange(n) * N // n, np.arange(n)] = True
    else:
        mem = rng.random((N, n)) < 0.4
    cost = rng.uniform(0.3, 3.0, n).astype(np.float32)
    sel = rng.random(n) < 0.25
    return mu, sg, best, mem, cost, sel


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# --- EIrate -------------------------------------------------------------------

@pytest.mark.parametrize("n,N,bm,bu,layout", [
    pytest.param(64, 8, 64, 8, "random", id="64-8-64-8"),
    pytest.param(200, 33, 64, 16, "random", id="200-33-64-16"),
    pytest.param(513, 100, 128, 64, "random", id="513-100-128-64"),
    pytest.param(17, 3, 256, 256, "random", id="17-3-256-256"),
    # disjoint membership: the Fig-5 episode's shape, and N not a multiple
    # of 32 with n not of 16
    pytest.param(2500, 50, 512, 64, "disjoint", id="2500-50-512-64-disjoint"),
    pytest.param(513, 33, 128, 64, "disjoint", id="513-33-128-64-disjoint"),
])
def test_eirate_plain_matches_pallas_and_ref(rng, n, N, bm, bu, layout):
    arrays = _ei_inputs(rng, n, N, layout)
    if layout == "disjoint":
        assert (arrays[3].sum(0) == 1).all()
    got = ops.eirate(*_t(*arrays)).numpy()
    j = [jnp.asarray(a) for a in arrays]
    pallas = jops.eirate(*j, block_models=bm, block_users=bu, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jref.eirate_ref(*j)),
                               atol=1e-4, rtol=1e-4)
    assert (got[arrays[5]] == -1e30).all()


def test_eirate_sigma_zero_is_exact(rng):
    """sigma == 0 takes max(mu - best, 0), summed over member tenants in
    ascending order: bit-equal to the same float32 sum in numpy."""
    n, N = 40, 6
    mu, _, best, mem, cost, _ = _ei_inputs(rng, n, N)
    sg = np.zeros(n, np.float32)
    sel = np.zeros(n, bool)
    got = ops.eirate(*_t(mu, sg, best, mem, cost, sel)).numpy()
    total = np.zeros(n, np.float32)
    for i in range(N):
        total = total + np.where(mem[i], np.maximum(mu - best[i], 0), 0).astype(np.float32)
    np.testing.assert_array_equal(got, total / cost)


def test_eirate_ties_are_bit_equal():
    """Equal inputs give bit-equal scores, so the argmax is the first index."""
    n, N = 48, 3
    mu, sg, best = np.zeros(n, np.float32), np.ones(n, np.float32), np.zeros(N, np.float32)
    mem, cost, sel = np.ones((N, n), bool), np.ones(n, np.float32), np.zeros(n, bool)
    got = ops.eirate(*_t(mu, sg, best, mem, cost, sel))
    assert (got == got[0]).all()
    assert int(torch.argmax(got)) == 0


def test_eirate_deep_tail_underflows_to_zero():
    """A candidate far below every incumbent scores exactly 0, as the
    reference (XLA flushes subnormals) does — not a subnormal that would
    outrank an equal neighbour in the argmax."""
    mu = np.array([0.0, 0.0, 0.0], np.float32)
    sg = np.array([0.0370, 0.0371, 1.0], np.float32)
    best = np.array([0.5], np.float32)    # u ~ -13.5: phi(u), Phi(u) subnormal
    mem, cost, sel = np.ones((1, 3), bool), np.ones(3, np.float32), np.zeros(3, bool)
    u = torch.tensor(-13.5)
    assert 0 < float(torch.exp(-u * u / 2)) < ref.FLT_MIN   # subnormal unflushed
    got = ops.eirate(*_t(mu, sg, best, mem, cost, sel)).numpy()
    assert got[0] == 0.0 and got[1] == 0.0 and got[2] > 0
    from repro.core.ei import eirate_scores
    want = np.asarray(eirate_scores(*[jnp.asarray(a) for a in (mu, sg, best, mem, cost, sel)]))
    np.testing.assert_array_equal(got, want)


# --- EIrate top-k -------------------------------------------------------------

@pytest.mark.parametrize("n,N,k,bm,bu", [
    (64, 8, 4, 64, 8), (200, 33, 8, 64, 16), (513, 100, 16, 128, 64),
    (17, 3, 4, 256, 256), (5, 2, 8, 256, 256),   # k > n: padded candidates
])
def test_eirate_topk_plain_matches_pallas_and_ref(rng, n, N, k, bm, bu):
    """The plain version against the Pallas top-k (interpret mode) and the
    flat jnp top-k: values to 1e-4 (the tolerance of test_kernels.py), ids
    equal wherever the value is above -1e29 (the -1e30 entries of the
    block-structured rounds and of a flat top-k differ in their ids)."""
    arrays = _ei_inputs(rng, n, N)
    v, i = ops.eirate_topk(*_t(*arrays), k=k)
    assert v.shape == (k,) and i.shape == (k,) and i.dtype == torch.int32
    j = [jnp.asarray(a) for a in arrays]
    for jv, ji in (jops.eirate_topk(*j, k=k, block_models=bm, block_users=bu,
                                    interpret=True),
                   jref.eirate_topk_ref(*j, k=k)):
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-4, rtol=1e-4)
        valid = np.asarray(jv) > -1e29
        np.testing.assert_array_equal(i.numpy()[valid], np.asarray(ji)[valid])
    # the head is the EIrate argmax, and the values are the scores themselves
    scores = ops.eirate(*_t(*arrays))
    assert int(i[0]) == int(torch.argmax(scores))
    live = v > -1e29
    np.testing.assert_array_equal(scores[i[live].long()].numpy(), v[live].numpy())


def test_eirate_topk_ties_take_the_lowest_ids():
    n, N, k = 600, 3, 6               # three blocks of 256 columns, all equal
    mu, sg, best = np.zeros(n, np.float32), np.ones(n, np.float32), np.zeros(N, np.float32)
    mem, cost, sel = np.ones((N, n), bool), np.ones(n, np.float32), np.zeros(n, bool)
    v, i = ops.eirate_topk(*_t(mu, sg, best, mem, cost, sel), k=k)
    assert i.tolist() == [0, 1, 2, 3, 4, 5] and (v == v[0]).all()
    jv, ji = jops.eirate_topk(*(jnp.asarray(a) for a in (mu, sg, best, mem, cost, sel)),
                              k=k, interpret=True)
    assert np.asarray(ji).tolist() == [0, 1, 2, 3, 4, 5]


def test_block_rounds_repeat_the_lowest_masked_index():
    """The TPU kernel's quirk, kept: a block with fewer live columns than
    k repeats its lowest -1e30 index in the later rounds."""
    scores = torch.full((300,), -1e30)
    scores[[10, 20, 270]] = torch.tensor([1.0, 2.0, 3.0])
    topv, topi = ref.block_topk_ref(scores, 4)
    assert topi.tolist() == [20, 10, 0, 0, 270, 256, 256, 256]
    assert topv[:2].tolist() == [2.0, 1.0] and topv[4] == 3.0
    v, i = ref.merge_block_topk(topv, topi, 300, 4)
    assert i.tolist() == [270, 20, 10, 0]


def test_eirate_topk_fused_matches_reference(rng):
    from repro.core import ei as jei
    from repro_torch.core import ei as tei
    arrays = _ei_inputs(rng, 40, 6)
    for k in (4, 50):
        v, i = tei.eirate_topk_fused(*_t(*arrays), k=k)
        jv, ji = jei.eirate_topk_fused(*(jnp.asarray(a) for a in arrays), k=k)
        assert v.shape == (min(k, 40),)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-4, rtol=1e-4)
        live = np.isfinite(np.asarray(jv))
        np.testing.assert_array_equal(i.numpy()[live], np.asarray(ji)[live])


# --- GP readout ----------------------------------------------------------------

@pytest.mark.parametrize("k,n,bk,bn", [
    (32, 64, 32, 64), (100, 257, 64, 128), (7, 1024, 512, 512), (512, 33, 128, 32),
    (0, 50, 512, 512),      # a block with no observation yet
])
def test_gp_readout_plain_matches_pallas_and_ref(rng, k, n, bk, bn):
    W = (rng.standard_normal((k, n)) * 0.3).astype(np.float32)
    alpha = rng.standard_normal(k).astype(np.float32)
    mu0 = rng.standard_normal(n).astype(np.float32)
    kd = ((W * W).sum(0) + np.abs(rng.standard_normal(n))).astype(np.float32)
    m1, v1 = (x.numpy() for x in ops.gp_readout(*_t(W, alpha, mu0, kd)))
    m2, s2 = (x.numpy() for x in ops.gp_readout(*_t(W, alpha, mu0, kd), emit_sd=True))
    np.testing.assert_array_equal(m1, m2)
    np.testing.assert_array_equal(s2, np.sqrt(v1))     # correctly rounded
    if k == 0:
        np.testing.assert_array_equal(m1, mu0)
        np.testing.assert_array_equal(v1, kd)
        return
    j = [jnp.asarray(a) for a in (W, alpha, mu0, kd)]
    mp, vp = jops.gp_readout(*j, block_n=bn, block_k=bk, interpret=True)
    mr, vr = jref.gp_readout_ref(*j)
    for want_mu, want_var in ((mp, vp), (mr, vr)):
        np.testing.assert_allclose(m1, np.asarray(want_mu), atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(v1, np.asarray(want_var), atol=2e-4, rtol=2e-4)
    _, sp = jops.gp_readout(*j, block_n=bn, block_k=bk, interpret=True, emit_sd=True)
    np.testing.assert_allclose(s2, np.asarray(sp), atol=2e-4, rtol=2e-4)


def test_gp_readout_variance_sums_rows_in_order(rng):
    """The sum of squares runs row by row in ascending order with separate
    rounding — the order of the engine's running diag_acc — so the
    variance is bit-equal to K_diag minus that running sum."""
    k, n = 37, 90
    W = (rng.standard_normal((k, n)) * 0.3).astype(np.float32)
    kd = ((W * W).sum(0) + 1.0).astype(np.float32)
    acc = np.zeros(n, np.float32)
    for r in range(k):
        acc = acc + W[r] * W[r]
    _, var = ops.gp_readout(*_t(W, np.zeros(k, np.float32), np.zeros(n, np.float32), kd))
    np.testing.assert_array_equal(var.numpy(), np.maximum(kd - acc, 0))


# --- no fallback ---------------------------------------------------------------

def test_kernel_wrappers_refuse_non_cuda_tensors(rng):
    """A tensor that is not on the CPU goes to the kernel wrapper, which
    launches or raises — it never drops to the plain version."""
    args = [t.to("meta") for t in _t(*_ei_inputs(rng, 16, 2))]
    with pytest.raises(ValueError, match="CUDA"):
        ops.eirate(*args)
    with pytest.raises(ValueError, match="CUDA"):
        ops.eirate_topk(*args, k=4)
    cm = torch.ones((2, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.eirate_classes(*args[:4], cm, args[5])
    W = torch.zeros((3, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.gp_readout(W, torch.zeros(3, device="meta"),
                       torch.zeros(16, device="meta"), torch.zeros(16, device="meta"))
    q = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, q, q)
    dt = torch.zeros((1, 8, 2), device="meta")
    b = torch.zeros((1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd_mix(q, dt, dt, b, b)


def test_flash_route_is_chosen_by_dtype_alone():
    """bf16 takes the wgmma kernel, float32 the tf32x3 kernel (tf32 wgmma,
    three products each), and any other dtype raises; the wgmma route's TMA checks refuse a base or a
    (b, s, h) stride that is no multiple of 16 bytes, and never look at the
    stride of a dimension of size 1."""
    from repro_torch.kernels import flash_attention as flash_mod
    assert flash_mod.route(torch.bfloat16) == "wgmma"
    assert flash_mod.route(torch.float32) == "tf32x3"
    with pytest.raises(TypeError):
        flash_mod.route(torch.float16)
    x = torch.zeros((1, 64, 4, 40), dtype=torch.bfloat16)
    tma.check("q", x[..., :32])
    with pytest.raises(ValueError, match="16-byte"):
        tma.check("q", x[..., 1:33])
    with pytest.raises(ValueError, match="16 bytes"):
        tma.check("q", torch.zeros((1, 64, 4, 20), dtype=torch.bfloat16))
    one = torch.zeros((1, 1, 1, 20), dtype=torch.bfloat16)
    assert tma.strides(one) == [8, 8, 8]
    tma.check("q", one)


@pytest.mark.parametrize("k,n,ldw,base,want", [
    (50, 50, 50, 0, "slab"),                      # the Fig-5 episode's blocks
    (0, 50, 50, 4, "slab"),                       # no observation yet
    (2, 3000, 3000, 0, "slab"),                   # 12,002 floats: still one block
    (1024, 100_000, 100_000, 0, "bulk"),          # service size: 391 blocks
    (1024, 25_000, 100_000, 100_000, "bulk_deep"),  # a shard's slice: 98 blocks
    (1024, 33_792, 33_792, 0, "bulk"),            # 132 blocks: every SM
    (1024, 33_788, 33_788, 0, "bulk"),            # 132 blocks, the last short
    (1024, 33_536, 33_536, 0, "bulk_deep"),       # 131 blocks
    (1024, 4096, 16_384, 0, "bulk_deep"),         # the fewest columns for a ring
    (1024, 4092, 16_384, 0, "column"),
    (256, 40_000, 40_008, 16, "bulk"),            # a slice 4 columns in
    (255, 40_000, 40_000, 0, "column"),           # too few rows for a ring
    (0, 100_000, 100_000, 0, "column"),           # k = 0 at service width
    (1024, 100_000, 100_000, 4, "column"),        # a slice one column in
    (1024, 100_000, 100_002, 0, "column"),        # rows 8 bytes apart
    (300, 40_001, 40_008, 0, "column"),           # n no multiple of 4
    (512, 2500, 2500, 0, "column"),               # the dense episode's n
])
def test_gp_readout_path_takes_the_widest_copy_the_layout_allows(k, n, ldw, base,
                                                                 want):
    """Small problems go to the slab kernel (one block, one wave of
    copies); k >= 256 rows over n >= 4,096 columns to a bulk-copy ring,
    only from a 16-byte aligned base with rows and n a multiple of 4
    columns: the 64 KB ring where the blocks of 256 columns cover the 132
    SMs, the deep one where they do not; the rest to one thread a
    column."""
    assert gp_readout.path(k, n, ldw, base, sms=132) == want


def test_ssd_route_is_chosen_by_dtype_alone():
    """bf16 x, b and c take the tensor-core kernels, float32 the tf32x3
    kernels (tf32 wgmma, three products each), any other dtype raises; the
    TMA checks pass the views of the model's fused projection and refuse a
    base that is no multiple of 16 bytes; a refused launch names its
    reason.  A call runs the route's three (bf16) or four (float32) CUDA
    kernels; when the sequence is one chunk, two: the bf16 route's states
    kernel (it takes lcum) and outputs, the float32 route's chunk products
    (G alone) and outputs."""
    from repro_torch.kernels import ssd as ssd_mod
    assert ssd_mod.route(torch.bfloat16) == "tensor_cores"
    assert ssd_mod.route(torch.float32) == "tf32x3"
    assert set(ssd_mod.launches_by_route) == {"tensor_cores", "tf32x3"}
    with pytest.raises(TypeError):
        ssd_mod.route(torch.float16)
    xbc = torch.zeros((2, 64, 4096 + 2 * 128), dtype=torch.bfloat16)  # mamba2-1.3b
    x = xbc[..., :4096].unflatten(-1, (64, 64))
    for name, t in (("x", x), ("b", xbc[..., 4096:4224]), ("c", xbc[..., 4224:])):
        tma.check(name, t)
    with pytest.raises(ValueError, match="16-byte"):
        tma.check("b", xbc[..., 4097:4225])
    assert tma.strides(xbc[..., 4096:4224]) == [64 * 4352, 4352]
    assert tma.launch_error(10000).startswith("a base address")
    assert "CUresult 1" in tma.launch_error(10003)
    for name in ("tensor_cores", "tf32x3"):
        assert ssd_mod.call_kernels(name, 300, 128) == ssd_mod.ROUTE_KERNELS[name]
    assert len(ssd_mod.call_kernels("tensor_cores", 2048, 256)) == 3
    assert len(ssd_mod.call_kernels("tf32x3", 2048, 256)) == 4
    assert len(ssd_mod.call_kernels("tensor_cores", 256, 256)) == 2
    assert len(ssd_mod.call_kernels("tensor_cores", 96, 256)) == 2
    assert ssd_mod.call_kernels("tf32x3", 513, 513) == ("ssd_tf32x3_chunk_kernel",
                                                        "ssd_tf32x3_out_kernel")
    assert len(ssd_mod.call_kernels("tf32x3", 96, 256)) == 2
    assert len(ssd_mod.ROUTE_KERNELS["tensor_cores"]) == 3
    assert len(ssd_mod.ROUTE_KERNELS["tf32x3"]) == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_refuses_a_state_wider_than_128_on_either_route(dtype):
    """N > 128 is refused, with its reason, before any device is looked at,
    so nothing launches and no call is counted."""
    from repro_torch.kernels import ssd as ssd_mod
    before = (ssd_mod.launches, dict(ssd_mod.launches_by_route))
    x = torch.zeros((1, 8, 2, 16), device="meta", dtype=dtype)
    dt = torch.zeros((1, 8, 2), device="meta")
    b = torch.zeros((1, 8, 256), device="meta", dtype=dtype)
    with pytest.raises(ValueError, match="N 256 must be in 1..128"):
        ops.ssd_mix(x, dt, dt, b, b)
    x, dt, b = (torch.zeros(t.shape, dtype=t.dtype) for t in (x, dt, b))
    with pytest.raises(ValueError, match="N 256"):     # CPU tensors, straight to the wrapper
        ssd_mod.ssd_mix(x, dt, dt, b, b)
    assert (ssd_mod.launches, ssd_mod.launches_by_route) == before


def test_topk_buffers_hold_the_candidates_and_the_outputs():
    """One scratch of blocks * kb (values, indices) and the (k,) outputs."""
    cand_v, cand_i, out_v, out_i = ei_score.topk_buffers(1000, 6, torch.device("cpu"))
    assert cand_v.shape == cand_i.shape == (4 * 6,)
    assert (cand_v.dtype, cand_i.dtype) == (torch.float32, torch.int32)
    assert out_v.shape == out_i.shape == (6,)
    assert (out_v.dtype, out_i.dtype) == (torch.float32, torch.int32)
    assert ei_score.topk_buffers(3, 8, torch.device("cpu"))[0].shape == (3,)


def test_build_is_keyed_on_the_source():
    """Each source builds into its own library under build/repro_torch/,
    named by a hash of source and flags (a second run reuses it)."""
    assert _build.sources() == ["ei_classes", "ei_score", "ei_topk",
                                "flash_attention", "flash_attention_sm90",
                                "gp_readout", "ssd", "ssd_sm90"]
    for name in _build.sources():
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.parent.parts[-2:] == ("build", "repro_torch")
        assert path.name.startswith(f"lib{name}-") and path == _build.library_path(name)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    # the kernels held bit-equal contract no multiply-adds; the two held to
    # a tolerance may
    for name in _build.sources():
        assert ("-fmad=false" in _build.flags(name)) == (name not in _build.FMA_SOURCES)
    assert _build.FMA_SOURCES == {"flash_attention", "flash_attention_sm90", "ssd"}


PTX_SAMPLE = """
.visible .entry other(
)
{
	.reg .f64 	%fd<3>;
	fma.rn.f64 	%fd1, %fd2, %fd2, %fd2;
	ret;
}
.visible .entry probe_tau(
	.param .u64 probe_tau_param_0
)
{
	.reg .pred 	%p<2>;
	.reg .f64 	%fd<9>;

	ld.param.u64 	%rd1, [probe_tau_param_0];
	fma.rn.f64 	%fd1, %fd2, %fd3, %fd4;
	@%p1 add.rn.f64 	%fd5, %fd1, %fd1;
	@!%p1 bra 	$L__BB0_2;
	sub.rn.f64 	%fd6, %fd5, %fd1;
	mul.rn.f32 	%f1, %f2, %f3;
	neg.f64 	%fd7, %fd6;
	setp.ge.f64 	%p1, %fd7, 0d4017AFB48DC96626;
$L__BB0_2:
	mul.rn.f64 	%fd8, %fd7, %fd7;
	ret;

}
"""


def test_fp64_count_follows_each_fp64_op_under_its_guard():
    """chip_smoke.py's counting probe of the EIrate term: probe_tau's PTX
    gains %fp64_n, set to 0 before its first instruction and raised by one
    after each FP64 fma, add, sub and mul under that instruction's guard;
    no other instruction and no other function is touched."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    out, counted = chip_smoke.fp64_counted_ptx(PTX_SAMPLE)
    assert counted == 4
    inc = "add.u32 \t%fp64_n, %fp64_n, 1;"
    lines = [ln.strip() for ln in out.splitlines()]
    tau = lines[lines.index(".visible .entry probe_tau("):]
    assert tau[3:5] == ["{", ".reg .b32 \t%fp64_n;"]
    first = tau.index("ld.param.u64 \t%rd1, [probe_tau_param_0];")
    assert tau[first - 1] == "mov.u32 \t%fp64_n, 0;"
    pairs = [(tau[i - 1], ln) for i, ln in enumerate(tau) if ln.endswith(inc)]
    assert pairs == [("fma.rn.f64 \t%fd1, %fd2, %fd3, %fd4;", inc),
                     ("@%p1 add.rn.f64 \t%fd5, %fd1, %fd1;", f"@%p1 {inc}"),
                     ("sub.rn.f64 \t%fd6, %fd5, %fd1;", inc),
                     ("mul.rn.f64 \t%fd8, %fd7, %fd7;", inc)]
    assert sum(ln.endswith(inc) for ln in lines) == 4      # none in `other`
    with pytest.raises(RuntimeError):
        chip_smoke.fp64_counted_ptx(PTX_SAMPLE.replace("probe_tau", "probe_x"))


@pytest.mark.parametrize("dropped", [0, 2, 5])
def test_device_ms_pads_its_windows_and_retries_empty_ones(monkeypatch, dropped):
    """chip_smoke.py's kernel-alone timing: each profiler window opens and
    closes with PROFILER_PAD_S idle around the calls; a window without a
    record of the kernel is taken again, up to PROFILER_ATTEMPTS; the mean
    is a kept window's device time over its count; with no window kept, the
    call is timed with CUDA events and that is noted."""
    import importlib.util
    import types
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    log, windows = [], []

    class Window:
        def __enter__(self):
            windows.append(len(windows) < dropped)
            log.append("enter")
            return self

        def __exit__(self, *exc):
            log.append("exit")

        def key_averages(self):
            rows = [types.SimpleNamespace(key="at::other", count=3, device_time_total=9.0)]
            if not windows[-1]:
                rows.append(types.SimpleNamespace(key="void my_kernel<64>(float*)",
                                                  count=4, device_time_total=10.0))
            return rows

    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: Window())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: log.append("sync"))
    monkeypatch.setattr(chip_smoke.time, "sleep", lambda s: log.append(("sleep", s)))
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, iters: 0.75)
    got = chip_smoke.device_ms(lambda: log.append("call"), "my_kernel", 4)
    attempts = min(dropped + 1, chip_smoke.PROFILER_ATTEMPTS)
    assert len(windows) == attempts
    pad = ("sleep", chip_smoke.PROFILER_PAD_S)
    window = ["enter", pad, "call", "call", "call", "call", "sync", pad, "exit"]
    assert log[:2] == ["call", "sync"]                    # the warm-up call
    starts = [i for i, x in enumerate(log) if x == "enter"]
    assert [log[i:i + len(window)] for i in starts] == [window] * attempts
    retries = chip_smoke.PROFILER_RETRIES
    if dropped < chip_smoke.PROFILER_ATTEMPTS:
        assert got == 10.0 / 4 / 1e3
        assert retries == [dict(kernels=["my_kernel"], attempt=a, device_names=1)
                           for a in range(1, dropped + 1)]
    else:
        assert got == 0.75
        assert retries[-1] == dict(kernels=["my_kernel"], timed_by="cuda_events", ms=0.75)
        assert len(retries) == chip_smoke.PROFILER_ATTEMPTS + 1
