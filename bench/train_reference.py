"""The plain reference of a training cell: the configuration's Mamba-2
language model (arXiv:2405.21060) written out from its equations in float32
PyTorch with TF32 off, its loss and gradients by autograd, layer by layer
under checkpointing, and AdamW with clipping in float32.

A block, on the residual stream x (B, S, d):

1. h = RMSNorm(x); separate projections z, x' (d -> d_inner each),
   B, C (d -> d_state each; one group) and dt' (d -> heads);
2. a causal depthwise convolution of width W over [x', B, C]
   (``F.conv1d``, left-padded), then SiLU;
3. dt = clamp(softplus(dt' + dt_bias), dt_min, dt_max), A = -exp(A_log);
4. the SSD as its masked quadratic form over the whole sequence, never a
   chunked scan: y_t = sum over s <= t of (C_t . B_s) exp(sum over s < r <= t
   of dt_r A) dt_s x'_s, the exponent a segment sum (``segsum``), computed a
   group of heads at a time; plus the skip D x'_t;
5. RMSNorm(y * SiLU(z)) (the gated norm), the output projection and the
   residual.

Then the final RMSNorm, the head tied to the embedding and the mean
cross-entropy of the next tokens.  The weights and the rows are the
benchmark's own (``train_inputs``); the reference takes nothing the program
made and imports nothing of it.  It follows the port where the port departs
from the published block (the configuration's ``assumed``): dt clamped in
the forward pass, RMSNorm's epsilon 1e-6, one B/C group.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench import train_inputs

#: heads whose (S, S) decay matrices are built at once
HEAD_GROUP = 8
BLOCK_LEAVES = ("norm.scale", "ssm.in_proj_zx", "ssm.in_proj_bc", "ssm.in_proj_dt",
                "ssm.conv_w", "ssm.conv_b", "ssm.A_log", "ssm.D", "ssm.dt_bias",
                "ssm.norm.scale", "ssm.out_proj")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): [t, s] = sum of a over s < r <= t, -inf above
    the diagonal."""
    T = a.shape[-1]
    below = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device), -1)
    sums = torch.cumsum(a[..., None].expand(*a.shape, T).masked_fill(~below, 0.0), dim=-2)
    causal = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device))
    return sums.masked_fill(~causal, -math.inf)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, P), dt (B, S, H), A (H,), Bm and Cm (B, S, N) ->
    y (B, S, H, P), without the D skip."""
    H = x.shape[2]
    scores = Cm @ Bm.transpose(1, 2)                                   # (B, t, s)
    ys = []
    for h0 in range(0, H, HEAD_GROUP):
        g = slice(h0, min(h0 + HEAD_GROUP, H))
        dtg = dt[:, :, g].transpose(1, 2)                              # (B, h, S)
        decay = torch.exp(segsum(dtg * A[g][None, :, None]))            # (B, h, t, s)
        mix = scores[:, None] * decay * dtg[:, :, None, :]
        ys.append(mix @ x[:, :, g].transpose(1, 2))                    # (B, h, t, P)
    return torch.cat(ys, dim=1).transpose(1, 2)


def block(x: torch.Tensor, p: dict, w: dict, eps: float) -> torch.Tensor:
    di, N, H, P, W = w["di"], w["N"], w["H"], w["P"], w["W"]
    B, S, _ = x.shape
    h = rmsnorm(x, p["norm.scale"], eps)
    z = h @ p["ssm.in_proj_zx"][:, :di]
    xs = h @ p["ssm.in_proj_zx"][:, di:]
    Bm = h @ p["ssm.in_proj_bc"][:, :N]
    Cm = h @ p["ssm.in_proj_bc"][:, N:]
    dt_raw = h @ p["ssm.in_proj_dt"]
    xbc = torch.cat([xs, Bm, Cm], dim=-1).transpose(1, 2)               # (B, C, S)
    conv = F.conv1d(F.pad(xbc, (W - 1, 0)), p["ssm.conv_w"].T[:, None, :],
                    p["ssm.conv_b"], groups=xbc.shape[1])
    xs, Bm, Cm = F.silu(conv).transpose(1, 2).split([di, N, N], dim=-1)
    dt = F.softplus(dt_raw + p["ssm.dt_bias"]).clamp(w["dt_min"], w["dt_max"])
    A = -torch.exp(p["ssm.A_log"])
    xh = xs.reshape(B, S, H, P)
    y = ssd(xh, dt, A, Bm, Cm) + p["ssm.D"][:, None] * xh
    y = rmsnorm(y.reshape(B, S, di) * F.silu(z), p["ssm.norm.scale"], eps)
    return x + y @ p["ssm.out_proj"]


def loss_of(params: dict, batch: dict, cfg: dict) -> torch.Tensor:
    w, eps = train_inputs.widths(cfg), cfg["norm_eps"]
    table = params["embed.table"]
    x = F.embedding(batch["tokens"].long(), table)
    for i in range(w["L"]):
        layer = {k: params[f"blocks.{k}.{i}"] for k in BLOCK_LEAVES}
        x = checkpoint(block, x, layer, w, eps, use_reentrant=False)
    x = rmsnorm(x, params["final_norm.scale"], eps)
    logits = x @ table.T
    return F.cross_entropy(logits.flatten(0, 1), batch["labels"].flatten().long())


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine down to
    ``min_lr_ratio`` of it at ``total_steps``."""
    if step < opt["warmup_steps"]:
        return opt["lr"] * step / max(opt["warmup_steps"], 1)
    frac = min(max((step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1),
                   0.0), 1.0)
    r = opt["min_lr_ratio"]
    return opt["lr"] * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * frac)))


def leaves(flat: dict, L: int) -> dict[str, torch.Tensor]:
    """Leaves one a layer: ``blocks.<name>.<layer>`` for the stacked block
    leaves, the others by their own path; float32 copies that require grad."""
    out = {}
    for k, v in flat.items():
        parts = [v[i] for i in range(L)] if k.startswith("blocks.") else [v]
        names = [f"{k}.{i}" for i in range(L)] if k.startswith("blocks.") else [k]
        for name, t in zip(names, parts):
            out[name] = t.detach().to(torch.float32).clone().requires_grad_()
    return out


def run(cfg: dict, traffic: dict, seed: int, device, steps: int) -> dict:
    """``steps`` training steps of the reference from the seed's weights on
    the seed's first rows: each step's loss, the first gradient's norm by
    leaf as AdamW takes it (clipped), and each leaf's change after the
    steps, by leaf (one a layer)."""
    w, opt = train_inputs.widths(cfg), cfg["optimizer"]
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        params = leaves(train_inputs.weights(cfg, seed, device), w["L"])
        start = {k: v.detach().clone() for k, v in params.items()}
        mu = {k: torch.zeros_like(v) for k, v in params.items()}
        nu = {k: torch.zeros_like(v) for k, v in params.items()}
        losses, first = [], {}
        names = list(params)
        for t in range(1, steps + 1):
            loss = loss_of(params, train_inputs.rows(cfg, traffic, seed, t - 1, device), cfg)
            grads = torch.autograd.grad(loss, [params[k] for k in names])
            losses.append(float(loss.detach()))
            with torch.no_grad():
                gnorm = torch.sqrt(sum(g.double().pow(2).sum() for g in grads)).item()
                scale = min(1.0, opt["clip_norm"] / max(gnorm, 1e-12))
                lr, b1, b2 = lr_at(opt, t), opt["b1"], opt["b2"]
                for k, g in zip(names, grads):
                    g = g * scale
                    if t == 1:
                        first[k] = float(torch.linalg.vector_norm(g))
                    mu[k].mul_(b1).add_(g, alpha=1 - b1)
                    nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    step = (mu[k] / (1 - b1 ** t)) / (torch.sqrt(nu[k] / (1 - b2 ** t)) + opt["eps"])
                    params[k].sub_(lr * (step + opt["weight_decay"] * params[k]))
            del grads, loss
        with torch.no_grad():
            change = {k: float(torch.linalg.vector_norm(params[k] - start[k])) for k in names}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return {"losses": losses, "grads": first, "changes": change}
