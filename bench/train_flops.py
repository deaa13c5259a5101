"""Model FLOPs a token of a training step, from the configuration's widths
alone: the yardstick of ``mfu_train``.  It is the same count whatever route
runs the scan, and counts no recomputation.

A forward pass, per token, counts 2 FLOPs a multiply-add of:

* each block's projections: z and x (d -> 2 d_inner), B and C
  (d -> 2 d_state), dt (d -> heads) and the output (d_inner -> d);
* the SSD worked as the chunked algorithm at the configuration's chunk Q
  (Mamba-2, Sec. 6): the chunk's C B^T scores (Q x d_state), its
  intra-chunk outputs (Q x heads x headdim), the outputs from the state
  carried in and the state's update (d_state x heads x headdim each), all
  over whole Q x Q blocks as the algorithm computes them;
* the head tied to the embedding (d -> the embedding's rows).

A training step is the forward pass and a backward pass of twice its
FLOPs: 3 times the forward.  The depthwise convolution (2 W d_conv-channels
a token, under 0.1% of a block), norms, gates and the optimizer are
elementwise and not counted.
"""

from __future__ import annotations

from bench import train_inputs


def forward_per_token(cfg: dict) -> int:
    w = train_inputs.widths(cfg)
    d, di, N, H, P, Q = w["d"], w["di"], w["N"], w["H"], w["P"], w["Q"]
    projections = 2 * d * (2 * di) + 2 * d * (2 * N) + 2 * d * H + 2 * di * d
    ssd = 2 * Q * N + 2 * Q * H * P + 2 * N * H * P + 2 * N * H * P
    return w["L"] * (projections + ssd) + 2 * d * w["V_rows"]


def per_token(cfg: dict) -> int:
    """FLOPs a token of one training step: forward and backward."""
    return 3 * forward_per_token(cfg)
