"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) block.

Counterpart of ``repro.models.ssm``:

  per step t:  h_t = a_t * h_{t-1} + dt_t * B_t (x) x_t      a_t = exp(dt_t * A)
               y_t = C_t . h_t + D * x_t

``ssm_train`` takes one of the reference's two routes by
``SSMConfig.use_pallas`` (the block's own switch, as in the reference):
True runs the SSD chunk-scan kernel through ``ops.ssd_mix`` (on the CPU
its plain version, the per-step recurrence), which has no backward pass
and raises under autograd; False (the default, and the route training
differentiates) runs the reference's chunked plain scan, which carries the
(B, H, P, N) state across chunks.  The prefill path
``ssm_train_with_state`` always takes the plain scan, since the kernel
returns no final state; decode is the O(1) recurrence.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..sharding.rules import (einsum, is_dtensor, local_along, on_shards,
                              with_logical_constraint)
from .layers import rmsnorm
from .spec import ParamSpec


class SSMConfig(NamedTuple):
    d_model: int
    d_inner: int          # expand * d_model
    headdim: int          # P
    d_state: int          # N
    conv_width: int = 4
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1
    use_pallas: bool = False

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.headdim


def ssm_specs(cfg: SSMConfig) -> dict:
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.num_heads
    conv_ch = di + 2 * N
    return {
        "in_proj_zx": ParamSpec((d, 2 * di), ("embed", "ssm_inner"), init="fan_in"),
        "in_proj_bc": ParamSpec((d, 2 * N), ("embed", "ssm_state"), init="fan_in"),
        "in_proj_dt": ParamSpec((d, H), ("embed", "ssm_heads"), init="fan_in"),
        "conv_w": ParamSpec((cfg.conv_width, conv_ch), ("conv_width", "ssm_inner"), init="fan_in"),
        "conv_b": ParamSpec((conv_ch,), ("ssm_inner",), init="zeros"),
        "A_log": ParamSpec((H,), ("ssm_heads",), init="ones"),
        "D": ParamSpec((H,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec((H,), ("ssm_heads",), init="zeros"),
        "norm": {"scale": ParamSpec((di,), ("ssm_inner",), init="ones")},
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed"), init="fan_in"),
    }


class SSMCache(NamedTuple):
    state: torch.Tensor   # (B, H, P, N) float32 recurrent state
    conv: torch.Tensor    # (B, W-1, conv_ch) last conv inputs
    length: torch.Tensor  # scalar int32


def ssm_cache_specs(cfg: SSMConfig, batch: int, dtype) -> SSMCache:
    H, P, N = cfg.num_heads, cfg.headdim, cfg.d_state
    conv_ch = cfg.d_inner + 2 * N
    return SSMCache(
        state=ParamSpec((batch, H, P, N), ("batch", "ssm_heads", None, "ssm_state"),
                        dtype=torch.float32, init="zeros"),
        conv=ParamSpec((batch, cfg.conv_width - 1, conv_ch),
                       ("batch", None, "ssm_inner"), dtype=dtype, init="zeros"),
        length=ParamSpec((), (), dtype=torch.int32, init="zeros"),
    )


def _split_proj(p: dict, u: torch.Tensor, cfg: SSMConfig):
    dt_ = u.dtype
    z, x = (u @ p["in_proj_zx"].to(dt_)).chunk(2, dim=-1)
    bc = u @ p["in_proj_bc"].to(dt_)
    dt_raw = u @ p["in_proj_dt"].to(dt_)
    return z, x, bc, dt_raw


def _conv_mix(p: dict, xbc: torch.Tensor, cfg: SSMConfig) -> torch.Tensor:
    """Depthwise causal conv1d, width W, over (B, S, C); on a DTensor, on
    each rank's shard (S unsplit, the weights split as the channels)."""
    if is_dtensor(xbc):
        x, (w, b), wrap = local_along(xbc, 1, p["conv_w"], p["conv_b"])
        return wrap(_conv_mix({"conv_w": w, "conv_b": b}, x, cfg))
    W, S = cfg.conv_width, xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(W):
        out = out + pad[:, i:i + S, :] * p["conv_w"][i].to(xbc.dtype)
    return F.silu(out + p["conv_b"].to(xbc.dtype))


def _dt_and_log_a(p: dict, dt_raw: torch.Tensor, cfg: SSMConfig):
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    dt = torch.clamp(dt, cfg.dt_min, cfg.dt_max)
    A = -torch.exp(p["A_log"].float())
    return dt, dt * A


def ssm_train(p: dict, u: torch.Tensor, cfg: SSMConfig, rules=None) -> torch.Tensor:
    """Full-sequence SSD, u (B, S, d_model): through the chunk-scan kernel
    with ``cfg.use_pallas``, else the chunked plain scan."""
    y, _ = _ssm_forward(p, u, cfg, rules)
    return y


def ssm_train_with_state(p: dict, u: torch.Tensor, cfg: SSMConfig,
                         rules=None) -> tuple[torch.Tensor, dict]:
    """Full-sequence SSD that also returns the decode cache (prefill path)."""
    return _ssm_forward(p, u, cfg, rules, want_state=True)


def mix_inputs(p: dict, u: torch.Tensor, cfg: SSMConfig):
    """The SSD mix's inputs from the block input u (B, S, d_model):
    (xh (B, S, H, P), dt, log_a (B, S, H), Bmat, Cmat (B, S, N), the chunk
    Q), and the gate z and conv input that the block needs besides."""
    B, S, _ = u.shape
    Q = min(cfg.chunk, S)
    if S % Q:
        Q = S               # irregular length: single chunk
    z, x, bc, dt_raw = _split_proj(p, u, cfg)
    xbc_raw = torch.cat([x, bc], dim=-1)
    xbc = _conv_mix(p, xbc_raw, cfg)
    x, bc = xbc[..., :cfg.d_inner], xbc[..., cfg.d_inner:]
    Bmat, Cmat = bc.chunk(2, dim=-1)                             # (B, S, N) each
    dt, log_a = _dt_and_log_a(p, dt_raw, cfg)                    # (B, S, H)
    xh = x.reshape(B, S, cfg.num_heads, cfg.headdim)
    return (xh, dt, log_a, Bmat, Cmat, Q), (z, xbc_raw)


def chunked_scan(xh, dt, log_a, Bmat, Cmat, Q: int):
    """The plain route's SSD mix: the reference's chunked scan over
    (B, S, H, P) ``xh`` in chunks of ``Q`` steps, carrying the (B, H, P, N)
    state across chunks.  Returns (y (B, S, H, P) float32, without the D * x
    term; the final state)."""
    B, S, H, P = xh.shape
    N = Bmat.shape[-1]
    nc = S // Q

    def chunks(t):
        return t.reshape(B, nc, Q, *t.shape[2:]).transpose(0, 1)  # (nc, B, Q, ...)

    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    state = xh.new_zeros((B, H, P, N), dtype=torch.float32)   # a DTensor on DTensors
    ys = []
    for xq, bq, cq, dtq, laq in zip(chunks(xh), chunks(Bmat), chunks(Cmat),
                                    chunks(dt), chunks(log_a)):
        lcum = on_shards(torch.cumsum, laq, (1,), 1)              # (B, Q, H) inclusive
        # intra-chunk: M[t,s] = (C_t.B_s) * exp(lcum_t - lcum_s) * dt_s, s <= t
        scores = einsum("btn,bsn->bts", cq, bq)             # (B, Q, Q)
        decay = lcum[:, :, None, :] - lcum[:, None, :, :]         # (B, t, s, H)
        m = torch.where(causal[None, :, :, None], torch.exp(decay), 0.0)
        w = scores[..., None] * m * dtq[:, None, :, :]            # (B, t, s, H)
        y_intra = einsum("btsh,bshp->bthp", w.to(xq.dtype), xq)
        # inter-chunk: exp(lcum_t) * (C_t . state carried in)
        y_inter = einsum("btn,bhpn->bthp", cq.float(), state)
        y_inter = y_inter * torch.exp(lcum)[..., None]
        # state update: exp(l_end) state + sum_s exp(l_end - l_s) dt_s B_s (x) x_s
        l_end = lcum[:, -1, :]                                    # (B, H)
        w_state = torch.exp(l_end[:, None, :] - lcum) * dtq       # (B, Q, H)
        bx = einsum("bqh,bqn,bqhp->bhpn", w_state, bq.float(), xq.float())
        state = torch.exp(l_end)[:, :, None, None] * state + bx
        ys.append(y_intra.float() + y_inter)
    return torch.stack(ys, dim=1).reshape(B, S, H, P), state


def _ssm_forward(p: dict, u: torch.Tensor, cfg: SSMConfig, rules=None,
                 want_state: bool = False):
    S = u.shape[1]
    (xh, dt, log_a, Bmat, Cmat, Q), (z, xbc_raw) = mix_inputs(p, u, cfg)

    if cfg.use_pallas and not want_state:
        y = ops.ssd_mix(xh, dt, log_a, Bmat, Cmat, chunk=Q)
        return _ssm_epilogue(p, u, y, xh, z, cfg, rules), None

    y, state = chunked_scan(xh, dt, log_a, Bmat, Cmat, Q)
    out = _ssm_epilogue(p, u, y, xh, z, cfg, rules)
    if not want_state:
        return out, None
    cache = {
        "state": state,
        "conv": xbc_raw[:, S - (cfg.conv_width - 1):, :],
        "length": torch.tensor(S, dtype=torch.int32, device=u.device),
    }
    return out, cache


def _ssm_epilogue(p, u, y, xh, z, cfg: SSMConfig, rules=None):
    """D-skip, gating, norm, out-projection shared by both paths."""
    B, S, _ = u.shape
    y = y + p["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(B, S, cfg.d_inner).to(u.dtype)
    y = y * F.silu(z)
    y = rmsnorm(p["norm"], y)
    y = with_logical_constraint(y, ("batch", "seq", "ssm_inner"), rules)
    return y @ p["out_proj"].to(u.dtype)


def ssm_decode(p: dict, u: torch.Tensor, cache: SSMCache, cfg: SSMConfig,
               rules=None) -> tuple[torch.Tensor, SSMCache]:
    """One-token recurrence. u (B, 1, d_model)."""
    B = u.shape[0]
    H, P = cfg.num_heads, cfg.headdim
    z, x, bc, dt_raw = _split_proj(p, u, cfg)
    xbc = torch.cat([x, bc], dim=-1)[:, 0, :]                       # (B, C)
    conv_in = torch.cat([cache.conv, xbc[:, None, :]], dim=1)       # (B, W, C)
    mixed = einsum("bwc,wc->bc", conv_in.float(), p["conv_w"].float())
    mixed = F.silu(mixed + p["conv_b"].float()).to(u.dtype)
    x1, bc1 = mixed[..., :cfg.d_inner], mixed[..., cfg.d_inner:]
    Bv, Cv = bc1.chunk(2, dim=-1)                                   # (B, N)

    dt, log_a = _dt_and_log_a(p, dt_raw[:, 0, :], cfg)              # (B, H)
    xh = x1.reshape(B, H, P).float()
    bx = einsum("bh,bn,bhp->bhpn", dt, Bv.float(), xh)
    new_state = torch.exp(log_a)[:, :, None, None] * cache.state + bx
    y = einsum("bn,bhpn->bhp", Cv.float(), new_state)
    y = y + p["D"].float()[None, :, None] * xh
    y = y.reshape(B, 1, cfg.d_inner).to(u.dtype)
    y = y * F.silu(z)
    y = rmsnorm(p["norm"], y)
    out = y @ p["out_proj"].to(u.dtype)
    return out, SSMCache(state=new_state, conv=conv_in[:, 1:, :], length=cache.length + 1)
