"""Plain PyTorch versions of the port's kernels.

For the scheduler's kernels (EIrate, its top-k and class forms, the GP
readout) each is the simplest formulation that does the kernel's arithmetic
step for step: the same operations in the same order, each rounded on its
own (those kernels are built without multiply-add contraction), and the
elementary functions evaluated in float64 and rounded once (:func:`rn`).
The sums over tenants and over rows of W run in ascending order, as the
kernels' loops do.  The data plane's two (:func:`attention_ref`,
:func:`ssd_ref`) are the definitionally correct formulations -- full-matrix
attention, the per-step SSD recurrence -- in float32, and the kernels are
held to them within a stated tolerance.  Beside them, the arithmetic of
the tensor-core routes step for step: the bf16 routes
(:func:`attention_wgmma_route_ref`, :func:`ssd_chunked_ref`), where each
float32 factor is split into bf16 hi + lo, and the float32 routes
(:func:`attention_tf32x3_route_ref`, :func:`ssd_tf32x3_route_ref`), where
it is split into tf32 hi + lo and each product taken as three; the tiles
or chunks, and the float32 sums.  All run on any device: the
CPU path of ``ops`` takes the oracles, and ``chip_smoke.py`` holds each
kernel against them on the card.
"""

from __future__ import annotations

import torch

NEG_LARGE = -1e30
HALF_SQRT2 = 0.7071067811865476
LOG_2PI = 1.8378770664093453
FLT_MIN = torch.finfo(torch.float32).tiny


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush subnormal values to zero.  The reference runs on XLA, which
    flushes subnormal float32 results (CPU and TPU alike); flushing at the
    same steps makes an EI that underflows there underflow here too, so
    ties among exhausted candidates go to the same first index."""
    return torch.where(x.abs() < FLT_MIN, torch.zeros_like(x), x)


def rn(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of float32 ``x``, evaluated in float64 and rounded once to
    float32.  The float32 erf, erfc, exp and sqrt of the CPU and of the
    card differ in the last bit; the rounded float64 value is the same on
    both (and in the kernels), so a decision taken on one device is taken
    on the other."""
    return fn(x.double()).float()


def ndtr(u: torch.Tensor) -> torch.Tensor:
    """Phi(u), with erfc in the tails (Cephes' form, as jax.scipy's ndtr):
    accurate far below the mean, where 0.5 * (1 + erf) is zero."""
    w = u * HALF_SQRT2
    z = w.abs()
    y = torch.where(z < HALF_SQRT2, 1.0 + rn(torch.erf, w),
                    torch.where(w > 0, 2.0 - rn(torch.erfc, z),
                                rn(torch.erfc, z)))
    return ftz(0.5 * y)


def tau(u: torch.Tensor) -> torch.Tensor:
    """tau(u) = u * Phi(u) + phi(u), the EI shape function of Lemma 1."""
    pdf = ftz(rn(torch.exp, (LOG_2PI + u * u) / -2.0))
    return ftz(ftz(u * ndtr(u)) + pdf)


def expected_improvement(mu, sigma, best):
    """E[max(X - best, 0)] for X ~ N(mu, sigma^2), elementwise; exactly
    max(mu - best, 0) where sigma == 0.  Shapes broadcast."""
    positive = sigma > 0
    safe = torch.where(positive, sigma, torch.ones_like(sigma))
    diff = mu - best
    return torch.where(positive, ftz(safe * tau(diff / safe)),
                       torch.clamp_min(diff, 0.0))


def ei_total_ref(mu, sigma, best, membership) -> torch.Tensor:
    """(n,) tenant EI sum of every column, tenants in ascending order (the
    kernels' ``ei::ei_total_column``)."""
    mu = mu.float()
    ei = expected_improvement(mu[None, :], sigma.float()[None, :],
                              best.float()[:, None])
    ei = torch.where(membership.bool(), ei, torch.zeros_like(ei))
    total = torch.zeros_like(mu)
    for i in range(ei.shape[0]):          # ascending tenants, as the kernel
        total = total + ei[i]
    return total


def eirate_ref(mu, sigma, best, membership, cost, selected) -> torch.Tensor:
    """(n,) EIrate scores; -1e30 at selected models (the kernel's epilogue)."""
    scores = ftz(ei_total_ref(mu, sigma, best, membership) / cost.float())
    return torch.where(selected.bool(), torch.full_like(scores, NEG_LARGE),
                       scores)


def eirate_classes_ref(mu, sigma, best, membership, cost_matrix,
                       selected) -> torch.Tensor:
    """(C, n) class-axis EIrate scores: the tenant EI sum once, divided by
    each class's cost row; -1e30 at selected models and where the cost is
    not finite (a memory-gated model is excluded, not scored 0)."""
    cm = cost_matrix.float()
    scores = ftz(ei_total_ref(mu, sigma, best, membership)[None, :] / cm)
    drop = selected.bool()[None, :] | ~torch.isfinite(cm)
    return torch.where(drop, torch.full_like(scores, NEG_LARGE), scores)


#: model columns per block of the top-k kernel (the TPU kernel's bn)
BLOCK_MODELS = 256


def topk_first(values: torch.Tensor, k: int):
    """(values, positions) of the k largest entries along the last axis,
    equal values in ascending position: the order of ``lax.top_k``.  A
    stable descending sort (one for every row of a matrix); ``torch.topk``
    promises no order among equal values, so no decision path uses it."""
    v, pos = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], pos[..., :k]


def merge_block_topk(topv, topi, n: int, k: int):
    """The global top-k from per-block candidates (flat, block-major):
    candidates at index >= n are masked to -1e30, too few candidates are
    padded with (-1e30, 0), then :func:`topk_first`.  The top-k kernel's
    last block does this merge in its own code; :func:`eirate_topk_ref`
    (and the kernel's wrapper when n = 0) call this one."""
    v = torch.where(topi < n, topv, torch.full_like(topv, NEG_LARGE))
    i = topi
    if v.shape[0] < k:
        pad = k - v.shape[0]
        v = torch.cat([v, torch.full((pad,), NEG_LARGE, dtype=v.dtype,
                                     device=v.device)])
        i = torch.cat([i, torch.zeros(pad, dtype=i.dtype, device=i.device)])
    v, pos = topk_first(v, k)
    return v, i[pos]


def block_topk_ref(scores: torch.Tensor, k: int):
    """Per block of ``BLOCK_MODELS`` columns (``min(256, n)`` when n is
    smaller), kb = min(k, bn) rounds of: the largest value, the lowest index
    at it (``torch.argmax`` returns the first), then that entry set to -1e30.
    Columns past n in the last block hold -1e30.  Returns flat block-major
    candidates: values (blocks * kb,) float32, global indices int32."""
    n = scores.shape[0]
    bn = min(BLOCK_MODELS, max(n, 1))
    kb = min(k, bn)
    nb = -(-n // bn)
    work = torch.full((nb * bn,), NEG_LARGE, dtype=torch.float32,
                      device=scores.device)
    work[:n] = scores
    work = work.view(nb, bn)
    vals, idxs = [], []
    for _ in range(kb):
        idx = torch.argmax(work, dim=1, keepdim=True)
        vals.append(work.gather(1, idx))
        idxs.append(idx)
        work.scatter_(1, idx, NEG_LARGE)
    base = torch.arange(nb, device=scores.device)[:, None] * bn
    topi = (torch.cat(idxs, 1) + base).reshape(-1)
    return torch.cat(vals, 1).reshape(-1), topi.to(torch.int32)


def eirate_topk_ref(mu, sigma, best, membership, cost, selected, *, k: int = 4):
    """(values (k,), global indices (k,) int32) of the EIrate top-k, by the
    top-k kernel's block-structured rounds on :func:`eirate_ref`'s scores,
    so that kernel and plain version agree on every entry, -1e30 candidates
    included.  (A flat top-k of the scores agrees on every value and on the
    indices of values above -1e29.)"""
    scores = eirate_ref(mu, sigma, best, membership, cost, selected)
    topv, topi = block_topk_ref(scores, k)
    return merge_block_topk(topv, topi, scores.shape[0], k)


def gp_readout_ref(W, alpha, mu0, k_diag, *, emit_sd: bool = False):
    """(mu, var) over the k rows of W, or (mu, sd) with ``emit_sd``.  Rows
    are folded in ascending order, the order ``IncrementalGP`` sums its
    running ``diag_acc`` in."""
    W = W.float()
    alpha = alpha.float()
    dot = torch.zeros(W.shape[1], dtype=torch.float32, device=W.device)
    sq = torch.zeros_like(dot)
    for r in range(W.shape[0]):
        dot = dot + alpha[r] * W[r]
        sq = sq + W[r] * W[r]
    mu = mu0.float() + dot
    var = torch.clamp_min(k_diag.float() - sq, 0.0)
    return (mu, rn(torch.sqrt, var)) if emit_sd else (mu, var)


# --- the data plane -----------------------------------------------------------

def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None):
    """Naive full-matrix GQA attention in float32, one KV head at a time.
    q (B, S, Hq, D), k/v (B, S, Hkv, D) -> (B, S, Hq, D) in q's dtype.

    The flash kernel's conventions: masked scores are -1e30, masked
    probabilities are zeroed after the exp, and the row sum is clamped at
    1e-30 (a fully masked row gives 0, not NaN).  Query head h reads KV
    head h // (Hq / Hkv)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    scale = 1.0 / float(D) ** 0.5
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for g in range(Hkv):
        qg = q[:, :, g * G:(g + 1) * G].float()                  # (B,S,G,D)
        kg = k[:, :, g].float()                                  # (B,S,D)
        vg = v[:, :, g].float()
        s = torch.einsum("bqgd,bsd->bgqs", qg, kg) * scale
        s = torch.where(mask, s, NEG_LARGE)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        p = torch.where(mask, p, 0.0)
        o = torch.einsum("bgqs,bsd->bqgd", p, vg)
        denom = torch.clamp_min(p.sum(-1), 1e-30)                # (B,G,S)
        out[:, :, g * G:(g + 1) * G] = (
            o / denom.permute(0, 2, 1)[..., None]).to(q.dtype)
    return out


def ssd_ref(x, dt, log_a, b, c):
    """The per-step SSD recurrence (the definitionally correct oracle).

    x (B, S, H, P), dt/log_a (B, S, H), b/c (B, S, N) -> y (B, S, H, P)
    float32, y_t = C_t . h_t with h_t = exp(log_a_t) h_{t-1} +
    dt_t B_t (x) x_t (no D * x skip term)."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    xdt = x.float() * dt.float()[..., None]
    decay = torch.exp(log_a.float())
    bf, cf = b.float(), c.float()
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = (decay[:, t, :, None, None] * h
             + xdt[:, t, :, :, None] * bf[:, t, None, None, :])
        ys.append(torch.einsum("bn,bhpn->bhp", cf[:, t], h))
    return torch.stack(ys, 1)


def bf16_split(v: torch.Tensor, split: bool = True) -> tuple[torch.Tensor, ...]:
    """The bf16 operands that stand for a float32 factor on the tensor
    cores, as float32 tensors: (hi, lo) with hi = bf16(v) and
    lo = bf16(v - hi), about 16 significant bits together; or (hi,) alone
    without ``split``, one bf16 rounding (2^-9)."""
    hi = v.bfloat16().float()
    return (hi, (v - hi).bfloat16().float()) if split else (hi,)


def attention_wgmma_route_ref(q, k, v, *, causal: bool = True,
                              window: int | None = None, split_p: bool = True):
    """The bf16 flash route's arithmetic (``csrc/flash_attention_sm90.cu``)
    step for step: key tiles of 128 (64 at D > 128), scores q . k in
    float32 (products of bf16 values are exact), the online softmax in
    float32, P V as P_hi V + P_lo V (:func:`bf16_split`; with ``split_p``
    False, P rounded once to bf16), float32 accumulation of O and of the
    row sum (from the float32 P), the output rounded to q's dtype.  Masked
    scores -1e30, masked P 0, the row sum clamped at 1e-30.
    q (B, S, Hq, D), k/v (B, S, Hkv, D) -> (B, S, Hq, D)."""
    B, S, Hq, D = q.shape
    G = Hq // k.shape[2]
    tile = 128 if D <= 128 else 64
    qf = q.float().permute(0, 2, 1, 3)                            # (B, Hq, S, D)
    kf = k.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    scale = 1.0 / float(D) ** 0.5
    rows = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, Hq, S, 1), NEG_LARGE, device=q.device)
    l = torch.zeros((B, Hq, S, 1), device=q.device)
    o = torch.zeros((B, Hq, S, D), device=q.device)
    for k0 in range(0, S, tile):
        keys = torch.arange(k0, min(k0 + tile, S), device=q.device)[None, :]
        live = torch.ones((S, keys.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            live &= keys <= rows
        if window is not None:
            live &= keys > rows - window
        s = (qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)) * scale
        s = torch.where(live, s, NEG_LARGE)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.where(live, torch.exp(s - m_new), 0.0)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr
        for part in bf16_split(p, split_p):
            o = o + part @ vf[:, :, k0:k0 + tile]
        m = m_new
    return (o / torch.clamp_min(l, 1e-30)).permute(0, 2, 1, 3).to(q.dtype)


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` rounded to tf32 (10 fraction bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32`` does: 2^12 added to the int32
    bit pattern, the low 13 bits cleared (a carry moves into the exponent;
    subnormals round on the same 2^-136 grid; NaN stays NaN)."""
    v = v.float()
    bits = (v.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF
    return torch.where(torch.isnan(v), v, bits.view(torch.float32))


def tf32_split(v: torch.Tensor, split: bool = True) -> tuple[torch.Tensor, ...]:
    """The tf32 operands that stand for a float32 factor on the tensor
    cores, as float32 tensors: (hi, lo) with hi = tf32(v) and
    lo = tf32(v - hi) (:func:`tf32_rna`; v - hi is exact), about 21
    significant bits together; or (hi,) alone without ``split``, one TF32
    rounding (2^-11)."""
    hi = tf32_rna(v)
    return (hi, tf32_rna(v - hi)) if split else (hi,)


def tf32x3_product(a: torch.Tensor, b: torch.Tensor, split: bool = True) -> torch.Tensor:
    """a @ b as the float32 flash route takes it on the tensor cores:
    a_hi b_lo + a_lo b_hi + a_hi b_hi (:func:`tf32_split`; a product of
    two tf32 values is exact in float32), float32 sums; without ``split``,
    tf32(a) @ tf32(b), one TF32 product."""
    if not split:
        return tf32_rna(a) @ tf32_rna(b)
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    return ah @ bl + al @ bh + ah @ bh


def tf32x3_einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
                  split: bool = True) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` with each product taken as
    :func:`tf32x3_product` takes it: a_hi b_lo + a_lo b_hi + a_hi b_hi,
    float32 sums; without ``split``, one TF32 product."""
    if not split:
        return torch.einsum(eq, tf32_rna(a), tf32_rna(b))
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    return torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bh)


def attention_tf32x3_route_ref(q, k, v, *, causal: bool = True,
                               window: int | None = None, split: bool = True):
    """The float32 flash route's arithmetic (``csrc/flash_attention.cu``)
    tile for tile: key tiles of 64 (32 at D > 128), scores
    :func:`tf32x3_product` (Q, K^T) in float32, the online softmax in
    float32, O += :func:`tf32x3_product` (P, V), the row sum from the
    float32 P, masked scores -1e30, masked P 0, the row sum clamped at
    1e-30.  Without ``split`` every product is one TF32 product (each
    factor rounded once to tf32).  q (B, S, Hq, D), k/v (B, S, Hkv, D)
    float32 -> (B, S, Hq, D) float32."""
    B, S, Hq, D = q.shape
    G = Hq // k.shape[2]
    tile = 64 if D <= 128 else 32
    qf = q.float().permute(0, 2, 1, 3)                            # (B, Hq, S, D)
    kf = k.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    scale = 1.0 / float(D) ** 0.5
    rows = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, Hq, S, 1), NEG_LARGE, device=q.device)
    l = torch.zeros((B, Hq, S, 1), device=q.device)
    o = torch.zeros((B, Hq, S, D), device=q.device)
    for k0 in range(0, S, tile):
        keys = torch.arange(k0, min(k0 + tile, S), device=q.device)[None, :]
        live = torch.ones((S, keys.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            live &= keys <= rows
        if window is not None:
            live &= keys > rows - window
        s = tf32x3_product(qf, kf[:, :, k0:k0 + tile].transpose(-1, -2), split) * scale
        s = torch.where(live, s, NEG_LARGE)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.where(live, torch.exp(s - m_new), 0.0)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + tf32x3_product(p, vf[:, :, k0:k0 + tile], split)
        m = m_new
    return (o / torch.clamp_min(l, 1e-30)).permute(0, 2, 1, 3)


def ssd_chunked_ref(x, dt, log_a, b, c, *, chunk: int = 256, split: bool = True):
    """The bf16 SSD route's arithmetic (``csrc/ssd_sm90.cu``) step for step:
    chunks of ``min(chunk, S)`` steps (the last may be short), lcum the
    inclusive cumsum of log_a within a chunk, l_end its last value, and

      y_t   = exp(lcum_t) (C_t . in_c) + sum_{s <= t} W'[t, s] x_s
      W'    = (C_t . B_s) exp(lcum_t - lcum_s) dt_s        (masked to s <= t)
      S_c   = sum_s x_s (x) B'_s,   B'_s = exp(l_end - lcum_s) dt_s B_s
      in_0  = 0,  in_{c+1} = exp(l_end_c) in_c + S_c

    where each float32 factor of a product (W', B', the carried state in)
    enters as its bf16 hi + lo (:func:`bf16_split`; one bf16 rounding
    without ``split``) and x, B and C as they are (bf16 on the route, exact
    in float32).  Sums in float32; the kernel sums in other orders (the
    tensor cores, a warp scan for lcum) and takes W''s decay as
    2^((lcum_t - lcum_s) log2 e) on MUFU.EX2.  x (B, S, H, P), dt/log_a
    (B, S, H), b/c (B, S, N) -> y (B, S, H, P) float32, without the D * x
    term."""
    B, S, H, P = x.shape
    Q = min(chunk, S)
    xf, bf, cf = x.float(), b.float(), c.float()
    dtf, laf = dt.float(), log_a.float()
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    state = None                                         # in_c, (B, H, P, N)
    for c0 in range(0, S, Q):
        L = min(Q, S - c0)
        xc, bc, cc, dc = (t[:, c0:c0 + L] for t in (xf, bf, cf, dtf))
        lc = torch.cumsum(laf[:, c0:c0 + L], dim=1)      # (B, L, H)
        yc = torch.zeros((B, L, H, P), dtype=torch.float32, device=x.device)
        if state is not None:
            for part in bf16_split(state, split):
                yc = yc + torch.einsum("btn,bhpn->bthp", cc, part)
            yc = yc * torch.exp(lc)[..., None]
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
        causal = causal[None, :, :, None]
        g = torch.einsum("btn,bsn->bts", cc, bc)         # (B, t, s)
        decay = torch.exp(torch.where(causal, lc[:, :, None, :] - lc[:, None, :, :], 0.0))
        w = torch.where(causal, g[..., None] * decay * dc[:, None, :, :], 0.0)
        for part in bf16_split(w, split):                # (B, t, s, H)
            yc = yc + torch.einsum("btsh,bshp->bthp", part, xc)
        y[:, c0:c0 + L] = yc
        if c0 + L < S:
            l_end = lc[:, -1]                            # (B, H)
            bp = (torch.exp(l_end[:, None, :] - lc) * dc)[..., None] * bc[:, :, None, :]
            s_c = sum(torch.einsum("bshp,bshn->bhpn", xc, part)
                      for part in bf16_split(bp, split))
            state = s_c if state is None else torch.exp(l_end)[..., None, None] * state + s_c
    return y


def ssd_tf32x3_route_ref(x, dt, log_a, b, c, *, chunk: int = 256, split: bool = True):
    """The float32 SSD route's arithmetic (``csrc/ssd.cu``) chunk for chunk:
    the chunked SSD of :func:`ssd_chunked_ref` (chunks of ``min(chunk, S)``
    steps, the last may be short; lcum, W', S_c and in_c as there, with
    B''s weight w_s = exp(l_end - lcum_s) dt_s on x: S_c = (w x)^T B), with
    each of its four products -- C B^T, W' X, C in^T and (w x)^T B --
    taken as three TF32 products of the float32 factors
    (:func:`tf32x3_einsum`; one TF32 product without ``split``) and float32
    sums.  The kernels sum in other orders (the tensor cores, a warp scan
    for lcum) and take W''s decay as 2^((lcum_t - lcum_s) log2 e) on
    MUFU.EX2.  x (B, S, H, P), dt/log_a (B, S, H), b/c (B, S, N) float32 ->
    y (B, S, H, P) float32, without the D * x term."""
    B, S, H, P = x.shape
    Q = min(chunk, S)
    xf, bf, cf = x.float(), b.float(), c.float()
    dtf, laf = dt.float(), log_a.float()
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    state = None                                         # in_c, (B, H, P, N)
    for c0 in range(0, S, Q):
        L = min(Q, S - c0)
        xc, bc, cc, dc = (t[:, c0:c0 + L] for t in (xf, bf, cf, dtf))
        lc = torch.cumsum(laf[:, c0:c0 + L], dim=1)      # (B, L, H)
        yc = torch.zeros((B, L, H, P), dtype=torch.float32, device=x.device)
        if state is not None:
            yc = tf32x3_einsum("btn,bhpn->bthp", cc, state, split) * torch.exp(lc)[..., None]
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
        causal = causal[None, :, :, None]
        g = tf32x3_einsum("btn,bsn->bts", cc, bc, split)  # (B, t, s)
        decay = torch.exp(torch.where(causal, lc[:, :, None, :] - lc[:, None, :, :], 0.0))
        w = torch.where(causal, g[..., None] * decay * dc[:, None, :, :], 0.0)
        y[:, c0:c0 + L] = yc + tf32x3_einsum("btsh,bshp->bthp", w, xc, split)
        if c0 + L < S:
            l_end = lc[:, -1]                            # (B, H)
            xw = (torch.exp(l_end[:, None, :] - lc) * dc)[..., None] * xc
            s_c = tf32x3_einsum("bshp,bsn->bhpn", xw, bc, split)
            state = s_c if state is None else torch.exp(l_end)[..., None, None] * state + s_c
    return y
