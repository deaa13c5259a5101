"""The inputs of a training cell, made by the benchmark from the seed on the
run's device and handed alike to the program and to the plain reference:
the model's initial weights, laid out as the parameter tree the port's
Mamba-2 model takes, and the token rows of every step.

Weights are drawn by a ``torch.Generator`` on the device in a few large
calls (one normal draw for every matrix, one uniform draw for the step
sizes), then split into leaves; the distributions are the configuration's
``init`` group.  Rows are drawn step by step from a generator keyed by
(seed, step), so step ``i`` sees the same tokens in every run of a seed,
whatever ran before it.  Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def widths(cfg: dict) -> dict:
    """The sizes the model is built from, read from the configuration."""
    s = cfg["ssm_cfg"]
    d = cfg["d_model"]
    di = s["expand"] * d
    mult = cfg["pad_vocab_size_multiple"]
    return {"d": d, "L": cfg["n_layer"], "V": cfg["vocab_size"],
            "V_rows": -(-cfg["vocab_size"] // mult) * mult,
            "di": di, "N": s["d_state"], "P": s["headdim"], "H": di // s["headdim"],
            "W": s["d_conv"], "Q": s["chunk_size"], "C": di + 2 * s["d_state"],
            "dt_min": s["dt_min"], "dt_max": s["dt_max"]}


def leaf_shapes(cfg: dict) -> dict[str, tuple[tuple[int, ...], str]]:
    """Every leaf's dotted path -> (shape, init), block leaves stacked on a
    leading layer axis."""
    w = widths(cfg)
    d, L, di, N, H, W, C = w["d"], w["L"], w["di"], w["N"], w["H"], w["W"], w["C"]
    return {
        "embed.table": ((w["V_rows"], d), "embed"),
        "blocks.norm.scale": ((L, d), "ones"),
        "blocks.ssm.in_proj_zx": ((L, d, 2 * di), "in"),
        "blocks.ssm.in_proj_bc": ((L, d, 2 * N), "in"),
        "blocks.ssm.in_proj_dt": ((L, d, H), "in"),
        "blocks.ssm.conv_w": ((L, W, C), "conv"),
        "blocks.ssm.conv_b": ((L, C), "zeros"),
        "blocks.ssm.A_log": ((L, H), "A_log"),
        "blocks.ssm.D": ((L, H), "ones"),
        "blocks.ssm.dt_bias": ((L, H), "dt_bias"),
        "blocks.ssm.norm.scale": ((L, di), "ones"),
        "blocks.ssm.out_proj": ((L, di, d), "out"),
        "final_norm.scale": ((d,), "ones"),
    }


def _generator(device, *key: int) -> torch.Generator:
    seed = int(np.random.SeedSequence([k & (2**64 - 1) for k in key]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _std(cfg: dict, kind: str) -> float:
    """Standard deviation of a normal leaf: the configuration's ``init``."""
    w, init = widths(cfg), cfg["init"]
    return {"embed": init["embed_std"],
            "in": 1.0 / math.sqrt(w["d"]),
            "conv": 1.0 / math.sqrt(w["W"]),
            "out": 1.0 / math.sqrt(w["di"] * w["L"]) if init["out_proj_rescale"]
            else 1.0 / math.sqrt(w["di"])}[kind]


def weights(cfg: dict, seed: int, device, dtype=torch.float32) -> dict[str, torch.Tensor]:
    """The initial weights, a flat dict of dotted path -> tensor in ``dtype``."""
    w, init = widths(cfg), cfg["init"]
    shapes = leaf_shapes(cfg)
    normal = [(k, s, kind) for k, (s, kind) in shapes.items() if kind in ("embed", "in", "conv", "out")]
    sizes = [math.prod(s) for _, s, _ in normal]
    draw = torch.randn(sum(sizes), generator=_generator(device, seed, 1), device=device)
    out = {}
    for (k, s, kind), part in zip(normal, draw.split(sizes)):
        out[k] = part.view(s).mul_(_std(cfg, kind))
    del draw
    # step sizes log-uniform in [dt_min, dt_max], floored, then the bias that
    # softplus maps to them
    L, H = w["L"], w["H"]
    u = torch.rand((L, H), generator=_generator(device, seed, 2), device=device)
    lo, hi = math.log(w["dt_min"]), math.log(w["dt_max"])
    dt = torch.exp(u * (hi - lo) + lo).clamp_min(init["dt_init_floor"])
    for k, (s, kind) in shapes.items():
        if kind == "ones":
            out[k] = torch.ones(s, device=device)
        elif kind == "zeros":
            out[k] = torch.zeros(s, device=device)
        elif kind == "A_log":
            out[k] = torch.full(s, float(init["A_log"]), device=device)
        elif kind == "dt_bias":
            out[k] = dt + torch.log(-torch.expm1(-dt))
    return {k: out[k].to(dtype) for k in shapes}


def nest(flat: dict) -> dict:
    """A flat dict of dotted paths as the nested dicts the program takes."""
    tree: dict = {}
    for path, v in flat.items():
        *head, last = path.split(".")
        node = tree
        for part in head:
            node = node.setdefault(part, {})
        node[last] = v
    return tree


def flatten(tree: dict, prefix: str = "") -> dict:
    """The nested dicts' leaves by dotted path."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "."))
        else:
            out[path] = v
    return out


def rows(cfg: dict, traffic: dict, seed: int, step: int, device) -> dict[str, torch.Tensor]:
    """Step ``step``'s batch: ``traffic["batch"]`` rows of ``seq_len + 1``
    tokens drawn by Zipf's law over the vocabulary (rank r, token r - 1, with
    probability proportional to r ** -zipf_a), split into tokens and the
    next-token labels, int32 on ``device``."""
    B, S = traffic["batch"], traffic["seq_len"]
    ranks = torch.arange(1, cfg["vocab_size"] + 1, dtype=torch.float64, device=device)
    probs = ranks ** -float(traffic["zipf_a"])
    draw = torch.multinomial(probs / probs.sum(), B * (S + 1), replacement=True,
                             generator=_generator(device, seed, 3, step))
    draw = draw.view(B, S + 1).to(torch.int32)
    return {"tokens": draw[:, :-1].contiguous(), "labels": draw[:, 1:].contiguous()}
