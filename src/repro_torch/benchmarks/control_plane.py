"""Control-plane benchmarks: the scheduler math at service scale.

The port of the JAX package's ``benchmarks/control_plane.py``.  Covers the
two kernels of the decision (EIrate scoring, kernel 2; the GP posterior
readout, kernel 1), each beside its plain PyTorch version on the same
device, and the incremental-GP engines (dense vs block-diagonal) at |L| =
2500 (the Fig-5 synthetic scale) and |L| = 10k (service scale).

Rows the reference names after its XLA and interpret-mode paths are named
after the port's: ``eirate_plain_*`` (``kernels.ref.eirate_ref``),
``eirate_cuda_*`` (``kernels.ops.eirate``: kernel 2 on the card),
``gp_readout_plain_*`` and ``gp_readout_cuda_*`` (kernel 1).  On the CPU
both rows of a pair run the plain version.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core import synthetic_matern_problem
from ..core.gp import BlockIncrementalGP, IncrementalGP
from ..device import resolve
from ..kernels import ops, ref
from . import common
from .common import emit, time_us, wait


def bench_eirate(n: int, N: int, device=None) -> None:
    dev = resolve(device)
    rng = np.random.default_rng(0)

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    mu = f32(rng.standard_normal(n))
    sg = f32(np.abs(rng.standard_normal(n)))
    best = f32(rng.standard_normal(N))
    mem = torch.from_numpy(rng.random((N, n)) < 0.1).to(dev)
    cost = f32(rng.uniform(0.5, 2.0, n))
    sel = torch.from_numpy(rng.random(n) < 0.3).to(dev)
    args = (mu, sg, best, mem, cost, sel)

    size = f"{(N * n * 4) / 1e6:.1f}MB"
    emit(f"eirate_plain_n{n}_N{N}",
         time_us(ref.eirate_ref, *args, sync=True), bytes=size)
    emit(f"eirate_cuda_n{n}_N{N}", time_us(ops.eirate, *args, sync=True),
         bytes=size)


def bench_gp_readout(k: int, n: int, device=None) -> None:
    dev = resolve(device)
    rng = np.random.default_rng(0)
    W = torch.from_numpy((rng.standard_normal((k, n)) * 0.1).astype(np.float32)).to(dev)
    alpha = torch.from_numpy(rng.standard_normal(k).astype(np.float32)).to(dev)
    mu0 = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    kd = (W * W).sum(0) + 1.0

    flops = f"{2 * k * n / 1e6:.1f}M"
    emit(f"gp_readout_plain_k{k}_n{n}",
         time_us(ref.gp_readout_ref, W, alpha, mu0, kd, sync=True), flops=flops)
    emit(f"gp_readout_cuda_k{k}_n{n}",
         time_us(ops.gp_readout, W, alpha, mu0, kd, sync=True), flops=flops)


def bench_incremental_engines(device=None) -> None:
    dev = resolve(device)
    prob = synthetic_matern_problem(num_users=20 if common.FAST else 50,
                                    num_models_per_user=50, seed=0)
    n = prob.num_models
    order = np.random.default_rng(0).permutation(n)[: n // 2]
    K, mu0 = prob.K.astype(np.float32), prob.mu0.astype(np.float32)

    for name, gp in (
        ("gp_engine_dense", IncrementalGP(K, mu0, device=dev)),
        ("gp_engine_block", BlockIncrementalGP(
            K, mu0, BlockIncrementalGP.blocks_from_membership(prob.K, prob.membership),
            device=dev)),
    ):
        wait(None)
        t0 = time.perf_counter()
        for i in order:
            gp.observe(int(i), float(prob.z_true[i]))
            post = gp.posterior()
        wait(post)
        us = (time.perf_counter() - t0) / len(order) * 1e6
        emit(f"{name}_n{n}", us, events=len(order))


def main(device=None) -> None:
    bench_eirate(2500, 50, device)
    if not common.FAST:
        bench_eirate(10_000, 200, device)
    bench_gp_readout(1250, 2500, device)
    bench_incremental_engines(device)


if __name__ == "__main__":
    common.run_standalone("torch_control_plane", main, __doc__)
