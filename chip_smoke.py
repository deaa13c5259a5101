#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main path on one GPU and checks it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and
``nvcc``.  Phases, each printed as one JSON line; any failure exits non-zero:

  build          compile every kernel of ``src/repro_torch/kernels/csrc/`` for
                 sm_90a into ``build/repro_torch/`` (one nvcc per source, in
                 parallel; a library already built from the same source is
                 reused), and count the HGMMA (wgmma) instructions in the bf16
                 flash and SSD libraries' SASS and in the float32 flash and
                 SSD libraries' (``cuobjdump -sass``; there every HGMMA must be
                 a TF32 one): none fails; then a probe of the EIrate kernels' term (ndtr's
                 erf or erfc, and exp, in double), built with their flags:
                 its DFMA, DADD and DMUL in the SASS must be those of each
                 EIrate kernel, and a counting build of it gives the FP64
                 instructions each member pair executes on its own path
  kernels        each kernel against its plain PyTorch version on the card,
                 at the paper's size and at service size, with CUDA-event times
                 of the wrapper's call, the kernel alone (its device time under
                 torch.profiler) and the least time the card could take for the
                 same work (the EIrate kernels: bytes, float32 operations or
                 the FP64 instructions the inputs' terms execute, the
                 largest); the top-k kernel also with
                 CUDA events around its C launch only; the readout on each of
                 its three paths (slab, bulk, column: column slices at 1, 2
                 and 4 columns in, an n no multiple of 4), and the launch
                 floor, an empty kernel's device time
  episode_fig5   Algorithm 1 (mdmt, M = 4) on the Fig-5 problem, 50 tenants x
                 50 models, on the card and on the CPU: equal trial sequences,
                 and every decision launched the EIrate kernel once
  episode_dense  the same on a 1 x 2,048 prior, which takes the dense GP engine
  baselines      round_robin and random on the Azure workload, card vs CPU
  batched        the batched sweep engine (repro_torch.core.simulate_batch),
                 its step loop under torch.cuda.set_sync_debug_mode("error")
                 (the mode read inside it): (a) Fig. 5 --engine batched at
                 the reference driver's full protocol, M 1-16 (1, 2, 4, 8,
                 16) x 16 seeds of the 50 x 50 Matern problem, 80 episodes
                 of 2,516 steps in one call, every row, the wall and us an
                 episode, no launch of kernels 1-4; (b) five of its episodes
                 (seed 0 at M 1, 4, 16; two z overrides) equal to the event
                 engine's on the card (models, hints, devices; times within
                 1e-5), and those five as a batch on the CPU equal to their
                 rows of the card's grid, bit for bit; (c) Fig. 2 and 4
                 --engine batched at 8 seeds: every mdmt and round_robin
                 episode equal to the event engine's, the random ones held
                 to their invariants and equal to the CPU's, bit for bit;
                 (d) B 1,024 (M 1-16 x 64 seeds) in one call, its wall, us
                 an episode and peak memory, (a)'s episodes equal inside it;
                 (e) the quickstart example on the card and the CPU, equal
                 lines; (f) attention_decode(write_back=False) at qwen3-4b's
                 layer-0 shape (B 4, a 2,048-slot cache, before and after
                 the ring wraps): float32 against write_back=True and the
                 CPU at DATA_TOL, bf16 against its own float32 step
  figures        the port's paper-figure drivers (repro_torch.benchmarks,
                 Fig. 2-5) on the card, Fig. 2-4 at the JAX drivers' full
                 protocol (Fig. 2 and 4: 8 seeds; Fig. 3: 5), Fig. 5 at
                 BENCH_FAST's (M 1, 4, 16 x 2 repeats of the 50 x 50
                 Matern problem; the full protocol takes over 90 s):
                 every row, the EIrate and readout launches of exactly those
                 runs (EIrate = the mdmt picks), every t_reach_* finite; then
                 Fig. 2-4 at one seed on the card and on the CPU: equal
                 derived fields; speedup_vs_M1 and linearity recorded
  readout_decide the sharded plane's readout -> score -> pick at service size
                 (k_obs 1,024, n 100,000, N 1,000) at S = 1 and S = 4 shards
                 on the card, both score routes, against the unsharded
                 readout -> EIrate -> first argmax
  churn_sharded  the open-world plane through a seeded tenant trace (100
                 tenants of 50 models, four simulated training devices, a
                 retire + arrival + compact(max_moves=4) every 10 decisions,
                 reshard 4 -> 2 -> 4, 1,000 decisions), run as (a) sharded,
                 route eirate_topk, S = 4 logical shards on the card; (b) the
                 same with route eirate; (c) scorer ops; (d) (a) at S = 1;
                 (e) ops at S = 1; then (a) on the CPU with the plain
                 versions: (a) = (b) = (c) = CPU and (d) = (e) picks, and
                 eirate_topk launched once per shard per decision in (a);
                 then the top-k kernel held against its plain version on the
                 inputs run (a) gave it, timed as in ``kernels``
  devplane_churn the elastic device plane (DevPlaneEngine) through a seeded
                 tenant + device churn trace (400 sessions, up to 5,000 live
                 models, 16 devices of two classes, joins, leaves and
                 preemptions), run as (a) batched assignment, scorer ops;
                 (b) (a) with the sharded scorer, S = 4 logical shards on
                 the card; (c) a homogeneous fleet, batched; (d) (c) with
                 sequential assignment; (e) (a) with snapshots, crashed
                 halfway and recovered from the durable log and newest
                 snapshot; then (a) on the CPU with the plain versions, to
                 a horizon: (a) = (b) = (e) = CPU and (c) = (d) trials, and
                 the class-axis EIrate kernel launched once per scoring
                 pass in (a) and once per shard per pass in (b); then that
                 kernel held against its plain version on the inputs run (a)
                 gave it
  observability  every plane of repro_torch.obs on the card (tracer,
                 metrics, exporter, health with an SLO, forensics,
                 accounting; windows of 20 s): (a) devplane_churn's trace,
                 run bare, with the tracer built but disabled, with every
                 plane, and with every plane on the CPU: equal trials, and
                 alerts, export windows, capacity samples, span trees and
                 forensics card = CPU (values within 1e-6, max error
                 printed); the streaming example's entry point on the card
                 and the CPU (kernel 2, forensics from its scores: one
                 launch a decision), and its engine sharded over 4 shard
                 spans against ops (kernel 3's decide_topk); (b) (a)'s
                 planes-on run crashed halfway and recovered: durable alert
                 prefix + re-emitted suffix, export windows, forensics,
                 samples and span tree of the suffix equal (a)'s; (c) the
                 health demo's adversarial trace: every ALERT_KINDS entry,
                 card = CPU; (d) readout_decide's shape phased (S = 4, both
                 routes): the fused pick, the three phase spans,
                 phase_times in us, a torch.profiler capture of it; (e) ms a
                 policy launch bare, tracer off and every plane on, and the
                 disabled per-event sites' us against the reference's 1%
                 target (reported, not gated)
  suites         the JAX package's nine service suites, ported
                 (repro_torch.benchmarks: control, stream, shard, devchurn,
                 eventlog, dtrace, obs, capacity, chaos; kernels 1-4): (a)
                 each at its smoke shapes (BENCH_FAST) on the card and on the
                 CPU, rows equal less their host times (run.HOST_TIME_KEYS),
                 each section's kernels launched; (b) each at the reference's
                 full shapes on the card, BENCH_torch_<suite>.json written to
                 a temporary directory (schema 1, the card's stamp), every
                 row printed, the reference's gates asserted inside the
                 sections (the compaction pause bound, the >= 90% span
                 attribution and < 1% disabled-tracer overhead at |L| 100k,
                 the < 1% disabled live-plane sites, the >= 80% weak-gap
                 attribution at S = 8, chaos's regret bound and stranded
                 devices); the sharded sections put S = 1-8 logical shards
                 on the one card; (c) regress on (b)'s payloads: each
                 against itself flags nothing, its slowest row doubled is
                 flagged alone, another device kind is an environment
                 mismatch; each section's seconds and launches
  kernels_data_plane
                 the flash attention kernels against their plain version at
                 qwen3-4b's shape (bf16 and float32), olmo-1b's MHA,
                 h2o-danube-3-4b's sliding window at S 8,192 and an S that no
                 64 divides, in float32 also a ragged S and D 256 with a
                 window (bf16 takes the wgmma route, float32 the tf32x3 route,
                 three TF32 products a float32 one; each case names and
                 checks its route); the SSD
                 kernels at mamba2-1.3b's and zamba2's shapes (float32 x/b/c
                 take the tf32x3 route, bf16 the tensor-core route), a
                 single chunk and serve's float32 check (one chunk of 513
                 steps); every route also against its arithmetic step for
                 step; each with its tolerance, CUDA-event times of
                 the call, plain version and the one PyTorch call that
                 computes the same function (flash:
                 scaled_dot_product_attention; SSD: none), the kernels alone
                 under torch.profiler, and the bound at the peak of the
                 route's arithmetic (bf16 tensor cores; tf32x3: 3 x flops at
                 the TF32 rate) with the float32 CUDA-core bound beside it
  model_forward  qwen3-4b, then mamba2-1.3b, at full width and depth, random
                 weights from a seed, bf16, B 4 x S 2,048: forward_loss and
                 forward_logits_last on the card on the kernel route
                 (use_pallas, ssm.use_pallas), one flash launch a layer
                 (36, every one on the wgmma route) or one SSD call a layer
                 (48, every one on the tensor-core route) per forward and no
                 other kernel; the kernel held against
                 its plain version on layer
                 0's own inputs; then a CPU twin of the first 2 layers at S 256
                 in float32 (the card's flash and SSD calls on their tf32x3
                 routes), last logits equal to the card's
  serve          StaticBatchEngine on each model (4 requests, prompts of 100 to
                 1,000 tokens, 32 new tokens each, 2 slots): waves, decode
                 steps, slot utilisation, prefill and decode times; then one
                 decode_step after prefill of S - 1 tokens against the kernel
                 path's forward_logits_last of S tokens, held in float32
                 (every flash and SSD call on its tf32x3 route, the check
                 timed);
                 in bf16 its drift recorded at 2, 1/4, 1/2 and all of the
                 layers, and the card's bf16 prefill + decode held against
                 the CPU's at 2 layers
  model_families the hybrid, vlm, audio and moe families at full width,
                 random weights from a seed, bf16, B 4 x S 2,048, on the
                 kernel route: zamba2-2.7b (54 Mamba2 layers in 9 groups of
                 6 + the shared attention block: 54 SSD calls and 9 flash
                 calls a forward), paligemma-3b (256 patches of width 1,152
                 + 1,792 tokens, loss over the text; 18 flash calls at D 256
                 with one KV head), musicgen-medium (frames of width 1,536,
                 4 heads; 48 flash calls at D 64), qwen3-moe-235b-a22b (4 of
                 94 layers; 64 groups of 128 tokens, capacity 16) and
                 arctic-480b (2 of 35 layers, bf16 parameters; capacity 4,
                 the dense residual MLP): each line names the cuts with
                 their bytes, the launches of each forward (exactly the
                 flash and SSD calls above, no other kernel), each kernel
                 held against its plain version on the inputs the model
                 first gives it (zamba2: the first SSD layer and the shared
                 block's first call), a float32 twin card against CPU
                 (zamba2 one group + the shared block, paligemma and
                 musicgen 2 layers, qwen3-moe 1 layer with its expert ids
                 and keep masks equal; arctic's smoke config); then
                 StaticBatchEngine on zamba2 and qwen3-moe (the moe's waves
                 whole groups), decode after prefill held in float32 for
                 zamba2, paligemma, musicgen and qwen3-moe (the moe with one
                 group a pass and a slot for every token), musicgen
                 decoding 32 frames, and paligemma through the ported
                 serve_decode example
  train_pieces   one AdamW step (repro_torch.train) on mamba2-1.3b's full
                 parameter tree (bf16 params and gradients, float32
                 moments) with seeded gradients that clip, held against a
                 CPU twin of the first 2 layers (float32 rtol 1e-6, bf16 one
                 ulp), its CUDA-event time beside its bytes bound; int8
                 compression of the same gradients, codes and scales equal
                 to the CPU's leaf for leaf; and the cost model's analytic
                 step seconds (H100 peaks) for qwen3-4b and mamba2-1.3b at
                 each applicable shape on one card
  train_step     the training launcher (repro_torch.launch.train: the data
                 pipeline's batches, make_train_step by autograd, AdamW) on
                 olmo-1b, then mamba2-1.3b, at full width and depth, bf16
                 compute over float32 parameters and moments, remat full,
                 B 1 x S 4,096 (train_4k's global batch of 256 cut to 1), 3
                 steps: synced ms a step (steps 2-3), tokens/s, the losses
                 (finite), peak memory against the card's, no kernel launch
                 (the plain route); the plain attention's (or SSD scan's)
                 forward and backward alone at a layer's shapes, times the
                 layers, as a share of the step, beside the forward
                 kernel's time; the kernel route raising under autograd;
                 then a float32 twin of the first 2 layers at S 256: loss
                 and every gradient leaf card against CPU (2e-5 of the
                 leaf's max), remat full against none on the card (bit
                 equality printed)
  service        the example's protocol (repro_torch.examples.
                 multi_tenant_service: a prior from 8 trainings, 12 models,
                 5 trials, a crash, a restore, the run to its end) with real
                 smoke trials on the card: each training's wall time and z,
                 ms a decision, readout launches equal to the decisions that
                 read the posterior; then its float32 twin, each trial's
                 duration fixed to the cost model's estimate, twice on the
                 card (rerun with deterministic algorithms if the two part)
                 and once on the CPU: equal trial sequences, z within 1e-4;
                 bf16 z against float32 z recorded
  launch         the launch tooling (slice 16): (a) examples.train_100m's
                 CLI on the card, its full run (300 steps, B 4 x S 128,
                 checkpoints every 100; deterministic algorithms): losses
                 finite and falling, tokens/s, max_memory_allocated, no
                 kernel launch (the plain route); then its loop stopped
                 after step 150 (its checkpoint there) and resumed to 300:
                 the final loss equal to the CLI run's (bit equality
                 printed, held to LAUNCH_RESUME_RTOL); (b) one sharded train
                 step (DEFAULT_RULES, DTensor) of the same model in float32
                 on a world-1 NCCL (1, 1) mesh against the rules=None step:
                 loss (TRAIN_LOSS_RTOL) and every parameter
                 (LAUNCH_SHARDED_TOL_OF_LR); (c) the dry run's counted flops of
                 that step on a (1, 1) fake mesh against FlopCounterMode
                 over the real step on the card: equal; (d) the dry run
                 (python -m repro_torch.launch.dryrun --probe, one process
                 a cell, all started right after ``suites``, on the host's
                 spare cores while the data-plane phases run) at full
                 shapes on the fake 256-rank 16 x 16 mesh for
                 LAUNCH_DRYRUN_CELLS: each record's three terms, fits_hbm,
                 peak and trace seconds, then the roofline section's rows

Then a line listing each kernel, the card's name and power limit as
``nvidia-smi`` reports them, and as the last line
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import heapq
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
# H100 SXM, FP64 outside the tensor cores: 34 TFLOP/s, a DFMA two of them,
# about 132 SMs x 64 FP64 instructions a clock
FP64_INSTR_PER_S = 1.7e13
# float32 steps of one member pair's EI besides erf/erfc and exp (sub, div,
# scale, abs, add, halve, square, add, halve, mul, add, mul, accumulate):
# a floor, not a cost model
EI_F32_OPS = 13
# tau(u) as the EIrate kernels evaluate it (ei_column.cuh): ndtr's erf or
# erfc, and exp, in double; all the FP64 work of one member pair with
# sigma > 0.  Built with the kernels' flags twice: as it is, for the static
# count of its DFMA, DADD and DMUL in the SASS; and with FP64_COUNTED to
# PTX, where fp64_counted_ptx adds one to %fp64_n after each FP64 fma, add,
# sub and mul (under the same guard), so each thread stores how many of
# them it executed on its input (fp64_executed)
FP64_PROBE = r"""
#include "ei_column.cuh"
extern "C" __global__ void probe_tau(const float* u, float* y,
                                     unsigned* count, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  y[i] = ei::tau(u[i]);
#ifdef FP64_COUNTED
  asm volatile("st.u32 [%0], %%fp64_n;" :: "l"(count + i) : "memory");
#endif
}
"""
FP64_OPCODES = ("DFMA", "DADD", "DMUL")
FP64_PTX_OP = re.compile(r"^(\s*)(@!?%\w+\s+)?(?:fma|add|sub|mul)\.rn\.f64\s")
#: the built probe: its CUfunction and what the build phase reports of it
FP64_PROBE_STATE: dict = {}
# the launch floor: an empty kernel, launched as the readout's slab kernel
# is (one block of 256 threads) through cuLaunchKernel as probe_tau is
EMPTY_PROBE = r"""
extern "C" __global__ void __launch_bounds__(256) empty_kernel() {}
"""
EMPTY_PROBE_STATE: dict = {}

FIG5_HORIZON = 600.0           # before the pool runs dry: every decision scores
DENSE_HORIZON = 50.0           # about 200 decisions at M = 4, unit costs
TOPK = 4                       # candidates per shard (the planes' shard_topk)
READOUT_SHAPE = (1024, 100_000, 1000)   # readout_decide: k_obs, n, N

# churn_sharded: the tenant trace
CHURN_TENANTS = 100            # live at the start, each a Fig-5 block
CHURN_MODELS = 50              # models per tenant
CHURN_DEVICES = 4              # simulated training devices
CHURN_DECISIONS = 1000
CHURN_EVERY = 10               # decisions between retire + arrive + compact
CHURN_RESHARD = {400: 2, 600: 4}   # decision count -> new shard count
CHURN_CPU_DECISIONS = 500      # the CPU twin's run (all of it, or a prefix;
                               # cut from 1,000 to make room for devplane_churn)

# devplane_churn: benchmarks/device_churn.py's wave trace (arrival rate 4,
# seed 0, one fast join class, join / leave / preempt rates 0.05 / 0.02 /
# 0.03, session scale 25, uniform costs) at 400 sessions and m_max 50, so
# the plane holds thousands of live models as churn_sharded does
DEVPLANE_TRACE = dict(num_sessions=400, arrival_rate=4.0, seed=0,
                      initial_slices=16, join_classes=(("fast", 16, 2.0),),
                      join_rate=0.05, leave_rate=0.02, preempt_rate=0.03,
                      m_min=2, m_max=50, session_scale=25.0, cost="uniform")
DEVPLANE_FLEET = (("slow", 8), ("fast", 8))
DEVPLANE_MAX_LIVE = 5000
DEVPLANE_SHARDS = 4
DEVPLANE_SNAPSHOT_EVERY = 200  # processed events between snapshots in (e)
# observability: the streaming example's windows (export, health and
# capacity, sim-seconds) and SLO
OBS_WINDOW = 20.0
OBS_SLO = {"device_utilization": 0.25, "ttfo_p99": 100.0}
OBS_RTOL = 1e-6                # forensics values, card against CPU
OBS_SITE_ITERS = 20_000        # passes over the disabled per-event sites
DEVPLANE_CPU_HORIZON = np.inf  # the CPU twin's run (all of it, or a prefix
                               # to this many simulated seconds)
CLASSES_C = 4                  # device classes of the service-size case

# the data plane
BF16_OPS_PER_S = 989e12        # H100 SXM, dense bf16 on the tensor cores
TF32_OPS_PER_S = 495e12        # H100 SXM, dense TF32 on the tensor cores
# the float32 routes (tf32x3) of flash and of the SSD scan against their
# arithmetic tile for tile (ref.attention_tf32x3_route_ref,
# ref.ssd_tf32x3_route_ref): both take each product as three TF32 products
# and differ only in the order of sums and in the exp (base 2 on MUFU.EX2;
# the SSD scan's lcum also by a warp scan): 2e-5 of each value and of max
# |want|, a tenth of DATA_TOL's
ROUTE_TOL_F32 = (2e-5, 2e-5)
# a data-plane kernel against its plain version, by the output's dtype:
# |got - want| <= rtol |want| + atol_of_max max|want|.  float32: sums in
# another order, 2e-4 of each.  bf16: both sides compute in float32 and
# round the output once (at most one bf16 ulp apart, at most 2^-7 of the
# value): rtol 1e-2, and 1e-3 of max|want| where the value is near 0.  The
# bf16 routes enter each float32 factor of a product (flash's P; the SSD
# scan's W', B' and carried state) as bf16 hi + lo, about 2^-17 a term, so
# they keep float32 accuracy.  The absolute part scales with max|want|, so
# no limit nears the values held.
DATA_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (1e-2, 1e-3)}
FLASH_CASES = (                # name, B, S, Hq, Hkv, D, window, dtype
    ("qwen3_4b_bf16", 2, 2048, 32, 8, 128, None, torch.bfloat16),
    ("qwen3_4b_f32", 2, 2048, 32, 8, 128, None, torch.float32),
    ("ragged_s1000_f32", 2, 1000, 32, 8, 128, None, torch.float32),
    ("d256_window_f32", 1, 2048, 16, 4, 256, 512, torch.float32),
    ("olmo_1b_mha", 2, 2048, 16, 16, 128, None, torch.bfloat16),
    ("h2o_danube_3_4b_window", 1, 8192, 32, 8, 120, 4096, torch.bfloat16),
    ("ragged_s1000", 2, 1000, 32, 8, 128, None, torch.bfloat16),
    # the other families' shapes: zamba2's shared block (D 80, padded to
    # the 128 template), paligemma (D 256, one KV head), musicgen (D 64),
    # qwen3-moe (GQA 16)
    ("zamba2_2p7b_bf16", 2, 2048, 32, 32, 80, None, torch.bfloat16),
    ("zamba2_2p7b_f32", 2, 2048, 32, 32, 80, None, torch.float32),
    ("paligemma_3b_bf16", 2, 2048, 8, 1, 256, None, torch.bfloat16),
    ("paligemma_3b_f32", 2, 2048, 8, 1, 256, None, torch.float32),
    ("musicgen_medium_bf16", 2, 2048, 24, 24, 64, None, torch.bfloat16),
    ("qwen3_moe_bf16", 2, 2048, 64, 4, 128, None, torch.bfloat16),
)
SSD_CASES = (                  # name, B, S, H, P, N, chunk, dtype of x, b, c
    ("mamba2_1p3b", 2, 2048, 64, 64, 128, 256, torch.float32),
    ("zamba2_2p7b", 2, 2048, 80, 64, 64, 256, torch.float32),
    ("single_chunk", 2, 256, 64, 64, 128, 256, torch.float32),
    # serve's float32 decode-after-prefill check on mamba2-1.3b: S 513, one
    # chunk (models/ssm.py makes an S that the chunk does not divide one)
    ("serve_check_f32", 1, 513, 64, 64, 128, 513, torch.float32),
    ("mamba2_1p3b_bf16", 2, 2048, 64, 64, 128, 256, torch.bfloat16),
    ("zamba2_2p7b_bf16", 2, 2048, 80, 64, 64, 256, torch.bfloat16),
)
MODEL_ARCHS = ("qwen3-4b", "mamba2-1.3b")
MODEL_BATCH, MODEL_SEQ = 4, 2048
TWIN_LAYERS, TWIN_BATCH, TWIN_SEQ = 2, 2, 256
TWIN_TOL = 2e-4                # float32 on both: sums in another order
# bf16 on both, card and CPU: the two round the products of their own GEMMs,
# test_kernels.py's bf16 tolerance (atol = rtol) for two implementations
TWIN_TOL_BF16 = 5e-2
SERVE_PROMPTS = (100, 400, 700, 1000)
SERVE_NEW, SERVE_SLOTS, SERVE_MAX_LEN = 32, 2, 2048
CHECK_SEQ = 513                # decode after prefill: S - 1 = 512 prefilled
DECODE_TOL = 3e-2              # tests/test_models.py's
# model_families: (arch, cut, float32 twin layers) -- full width; qwen3-moe
# (2.49e9 parameters a layer, 10 GB in float32) cut to 4 of 94 layers;
# arctic (13.6e9 a layer: 54 GB in float32, more than the card with its bf16
# expert casts) cut to 2 of 35 layers of bf16 parameters, and twinned on its
# smoke config (no host holds a full-width layer's twin beside the card's)
FAMILY_ARCHS = (
    ("zamba2-2.7b", None, 6),                 # the twin: one group + shared block
    ("paligemma-3b", None, 2),
    ("musicgen-medium", None, 2),
    ("qwen3-moe-235b-a22b", dict(num_layers=4), 1),
    ("arctic-480b", dict(num_layers=2, param_dtype=torch.bfloat16), None),
)
TWIN_SMOKE_SEQ = 64            # the smoke twin: B 2 x 64 = 4 groups of 32
# serving: zamba2 the engine's default prompts; the moe's each wave's B plen
# a multiple of its 128-token group (waves of 2 x 384 and 2 x 1,024)
FAMILY_SERVE = {"zamba2-2.7b": SERVE_PROMPTS, "qwen3-moe-235b-a22b": (128, 384, 640, 1024)}
FAMILY_CHECK = ("zamba2-2.7b", "paligemma-3b", "musicgen-medium", "qwen3-moe-235b-a22b")
FRAMES_PROMPT = 512            # musicgen's prefill, frames a sequence
EXAMPLE_BATCH, EXAMPLE_PROMPT = 4, 256   # paligemma's serve_decode run

# batched: the batched sweep engine (core/sim_batched.py) on the card.  (a)
# Fig. 5 --engine batched at the reference driver's full protocol: M in
# BATCHED_DEVICES x BATCHED_SEEDS seeds of the 50 x 50 Matern problem (80
# episodes, T = 2,516 steps); (b) its episodes BATCHED_EVENT against the
# event engine (seed 0 at M 1, 4, 16; two z overrides); (c) Fig. 2 and 4
# --engine batched at BATCHED_FIG_SEEDS seeds; (d) BATCHED_SWEEP: M 1-16 x
# 64 seeds, B 1,024, DESIGN.md §6's scale; (e) the quickstart; (f) one
# write_back=False decode step at qwen3-4b's layer-0 attention shape, bf16,
# a cache of BATCHED_DECODE_CACHE slots for B 4
BATCHED_DEVICES = (1, 2, 4, 8, 16)
BATCHED_SEEDS = 16
BATCHED_EVENT = ((1, 0), (4, 0), (16, 0), (4, 1), (16, 2))   # (M, seed)
BATCHED_FIG_SEEDS = 8
BATCHED_SWEEP = (tuple(range(1, 17)), 64)
BATCHED_DECODE_CACHE = 2048
BATCHED_TIME_TOL = 1e-5        # start and end times, event (float64) vs batched (float32)
BF16_BRANCH_RATIO = 2.0        # (f): bf16 write_back=False's error against its float32
                               # step, at most this times write_back=True's

# figures: the port's paper-figure drivers, seeds per figure (Fig. 5:
# repeats of the 50 x 50 Matern problem at each M of FIG5_DEVICES); the CPU
# twin of Fig. 2-4 at FIG_TWIN_SEEDS.  Fig. 2-4 at the JAX drivers' full
# (not BENCH_FAST) protocol; Fig. 5 at BENCH_FAST's (1, 4, 16) x 2, since
# its full protocol, (1, 2, 4, 8, 16) x 5, took 121.8 s on an H100 80GB
# HBM3 at 700 W (PERF.md, run 20A), over the 90 s this phase gives it
# (`python -m repro_torch.benchmarks.run fig5` runs it in full)
FIG_SEEDS = {"fig2": 8, "fig3": 5, "fig4": 8, "fig5": 2}
FIG5_DEVICES = (1, 4, 16)
FIG5_PROTOCOL = ("BENCH_FAST's (1, 4, 16) x 2: the full (1, 2, 4, 8, 16) x 5 "
                 "took 121.8 s (PERF.md, run 20A), over 90 s")
FIG_TWIN_SEEDS = 1

# train_pieces: one AdamW step and one compression of the gradients on
# mamba2-1.3b's full parameter tree (bf16 params and gradients, float32
# moments), held against a CPU twin; the twin's AdamW takes the first
# TRAIN_TWIN_LAYERS layers of the stacked blocks (with the card's global
# norm), its compression every leaf whole (a scale is per leaf)
TRAIN_ARCH = "mamba2-1.3b"
TRAIN_TWIN_LAYERS = 2
TRAIN_STEP = 10                # the state's step before the update (warmup)
TRAIN_GRAD_STD = 1e-3          # N(0, std) gradients: a global norm of ~36 at
                               # 1.3e9 parameters, so the step clips
TRAIN_TOL_F32 = 1e-6           # rtol: the same float32 ops in the same order
                               # (pow may round apart on the two)
COST_ARCHS = ("qwen3-4b", "mamba2-1.3b")

# train_step: the training launcher (repro_torch.launch.train: the data
# pipeline's batches -> make_train_step -> AdamW) at full width and depth,
# bf16 compute, float32 parameters and moments, remat "full", B 1 x S 4,096:
# train_4k's sequence, its global batch of 256 cut to 1 to fit one card;
# then a float32 twin of the first TRAIN_TWIN_LAYERS layers at S
# TRAIN_TWIN_SEQ, card against CPU, and remat "full" against "none" on the card
TRAIN_STEP_ARCHS = ("olmo-1b", "mamba2-1.3b")
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 3, 1, 4096
TRAIN_CUT = "train_4k's global batch 256 -> 1 (one card); S 4,096 and full depth kept"
TRAIN_TWIN_SEQ = 256
# per gradient leaf, max |card - CPU| / max |CPU|, float32 on both (sums in
# other orders): tests/test_torch_train_step.py's float32 tolerance, where the
# port's gradients hold to jax.grad's
TRAIN_GRAD_TOL = 2e-5
TRAIN_LOSS_RTOL = 1e-6

# service: the example's protocol (repro_torch.examples.multi_tenant_service)
# on the card; then its float32 twin on the card (twice) and on the CPU, each
# trial's duration fixed to the cost model's estimate for its arch, so the
# trial order does not depend on the clock.  z to SERVICE_Z_RTOL: ten AdamW
# steps pass float32 gradient differences through g / (|g| + eps), which the
# train step holds to 1e-4 of a leaf's largest value
SERVICE_Z_RTOL = 1e-4

# launch: examples.train_100m's run (the reference's: 300 steps at B 4 x S
# 128), its resume from step LAUNCH_RESUME_AT, and the dry-run cells (arch,
# shape, rules) traced on the fake 256-rank mesh
LAUNCH_STEPS, LAUNCH_RESUME_AT = 300, 150
# the resumed run's final loss against the uninterrupted run's: one step's
# float32 rounding, should the two part under deterministic algorithms
LAUNCH_RESUME_RTOL = 1e-5
# (b): a parameter after the sharded step against the unsharded step's, as a
# share of the learning rate, beyond one ulp of its value
# (tests/test_torch_train_step.py's STEP_TOL_OF_LR)
LAUNCH_SHARDED_TOL_OF_LR = 2e-2
LAUNCH_DRYRUN_CELLS = (("qwen3-8b", "train_4k", "default"),
                       ("qwen3-8b", "train_4k", "preferred"),
                       ("musicgen-medium", "prefill_32k", "qrows"),
                       ("mamba2-1.3b", "long_500k", "default"),
                       ("arctic-480b", "train_4k", "fsdp"))
LAUNCH_DRYRUN_TIMEOUT_S = 600


def emit(obj) -> None:
    print(json.dumps(obj, allow_nan=False), flush=True)


def finite(x: float) -> float | None:
    """JSON has no infinity: a horizon of inf, or a regret level never
    reached, prints as null."""
    return float(x) if np.isfinite(x) else None


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call on the stream, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: profiler windows that kept no record of a kernel and were taken again,
#: each as its kernels, attempt and how many names with device time the
#: window kept; a kernel that no window recorded is listed with its CUDA-event
#: time (``timed_by``); emitted before the kernels line
PROFILER_RETRIES: list = []
PROFILER_ATTEMPTS = 5
#: idle seconds at each end of a profiler window: Kineto keeps only device
#: records that fall inside the window on the host's clock, and the card's
#: timestamps, mapped to that clock, can lie a few milliseconds off it
PROFILER_PAD_S = 0.05


def device_ms(fn, kernel, iters: int, parts: dict | None = None) -> float:
    """Mean device milliseconds per launch of the kernel whose name holds
    ``kernel``, under torch.profiler over ``iters`` calls of ``fn`` (after
    one warm-up call): the kernel alone, without host dispatch.  With a
    tuple of names (a route of several kernels), the sum of each one's
    mean: the device time of one call; ``parts`` then receives each
    kernel's mean by name.

    The profiler drops some of the card's activity records, now and then
    all of a window's records of one kernel (the launches themselves ran:
    the wrappers' counts and outputs are checked elsewhere).  Each window
    opens and closes with ``PROFILER_PAD_S`` idle, so that records whose
    mapped timestamps lie a little off the host's clock stay inside it.  A
    window that kept no record of a kernel is taken again, up to
    ``PROFILER_ATTEMPTS`` windows in all, each retry noted in
    ``PROFILER_RETRIES``; the mean is over the records a window kept.  If
    no window kept them, the call is timed with CUDA events instead
    (``cuda_ms``: host dispatch included, parts None), and that is noted
    there too."""
    from torch.profiler import ProfilerActivity, profile
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILER_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_PAD_S)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILER_PAD_S)
        averages = prof.key_averages()
        rows = {name: [e for e in averages if name in e.key] for name in names}
        missing = {name: [e.count for e in r] for name, r in rows.items()
                   if not (len(r) == 1 and 0 < r[0].count <= iters
                           and r[0].device_time_total > 0.0)}
        if not missing:
            break
        PROFILER_RETRIES.append(dict(
            kernels=sorted(missing), attempt=attempt,
            device_names=sum(e.device_time_total > 0.0 for e in averages)))
        print(f"chip_smoke: profiler window {attempt} kept no record of "
              f"{sorted(missing)}", file=sys.stderr, flush=True)
        time.sleep(0.2 * attempt)   # the drops come in runs: let one pass
    if missing:
        ms = cuda_ms(fn, iters)
        PROFILER_RETRIES.append(dict(kernels=sorted(missing), timed_by="cuda_events",
                                     ms=ms))
        print(f"chip_smoke: no profiler window kept a record of {sorted(missing)} "
              f"in {PROFILER_ATTEMPTS}; timed with CUDA events: {ms} ms",
              file=sys.stderr, flush=True)
        if parts is not None:
            parts.update({name: None for name in names})
        return ms
    total = 0.0
    for name in names:
        row = rows[name][0]
        mean = row.device_time_total / row.count / 1e3
        if parts is not None:
            parts[name] = mean
        total += mean
    return total


def bound_ms(nbytes: float, ops: float, fp64: float = 0.0) -> tuple[float, str]:
    """The least time for ``nbytes`` moved, ``ops`` float32 operations and
    ``fp64`` FP64 instructions: the largest of the three floors, and
    "bytes" or "operations" (float32 or FP64) for the one that sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / FP32_OPS_PER_S, fp64 / FP64_INSTR_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ei_fp64(mu, sg, best, mem) -> int:
    """FP64 instructions these inputs' terms execute: tau(u) at u = (mu[x]
    - best[i]) / sigma[x], as the kernels form it, for every member pair
    with sigma > 0, each counted on the path it takes (fp64_executed)."""
    pos = sg > 0
    u = (mu[None, :] - best[:, None]) / torch.where(pos, sg, 1.0)[None, :]
    return int(fp64_executed(u[mem.bool() & pos[None, :]]).sum())


# ---- kernels ------------------------------------------------------------------

def ei_inputs(N, n, layout, rng, dev):
    """EIrate inputs on the card: disjoint membership (one owner a model,
    the paper's workloads), dense random membership (40%), or the all-equal
    tie case; sigma = 0 and selected entries mixed in."""
    mu = rng.standard_normal(n).astype(np.float32)
    sg = np.abs(rng.standard_normal(n)).astype(np.float32)
    sg[rng.random(n) < 0.125] = 0.0                     # sigma = 0 entries
    best = rng.normal(0.5, 0.5, N).astype(np.float32)
    cost = rng.uniform(0.3, 3.0, n).astype(np.float32)
    sel = rng.random(n) < 0.25                          # selected entries
    if layout == "disjoint":            # the paper's workloads: one owner each
        mem = np.zeros((N, n), bool)
        mem[np.arange(n) * N // n, np.arange(n)] = True
    elif layout == "dense":
        mem = rng.random((N, n)) < 0.4
    else:                               # all-equal tie case
        mu[:], sg[:], best[:], cost[:], sel[:] = 0.0, 1.0, 0.0, 1.0, False
        mem = np.ones((N, n), bool)
    return [torch.from_numpy(a).to(dev) for a in (mu, sg, best, mem, cost, sel)]


def ei_bound(args, extra_ops=0, out_bytes=None):
    """The least time for an EIrate pass over these inputs: each input read
    once (membership N*n bytes, mu/sigma/cost 12n, selected n, best 4N) and
    each output written once (default: the (n,) float32 scores); float32:
    EI_F32_OPS per member pair with sigma > 0, 2 per pair at sigma = 0, 2
    per column; FP64: ei_fp64(), the instructions the terms execute.
    Returns (member pairs, FP64 instructions, bound ms, bound_by)."""
    mu, sg, best, mem, _, _ = args
    N, n = mem.shape
    pairs = int(mem.sum())
    pairs_pos = int(mem[:, sg > 0].sum())
    nbytes = N * n + 13 * n + 4 * N + (4 * n if out_bytes is None else out_bytes)
    ops = pairs_pos * EI_F32_OPS + (pairs - pairs_pos) * 2 + n * 2 + extra_ops
    fp64 = ei_fp64(mu, sg, best, mem)
    return (pairs, fp64) + bound_ms(nbytes, ops, fp64)


def eirate_case(name, N, n, layout, rng, dev, ei_score, ref):
    args = ei_inputs(N, n, layout, rng, dev)
    got = ei_score.eirate(*args)
    want = ref.eirate_ref(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err == 0.0, f"eirate {name}: kernel and plain version differ by {err}")
    if layout == "tie":
        check(bool((got == got[0]).all()) and int(torch.argmax(got)) == 0,
              "eirate tie case: equal inputs must give bit-equal scores")
    iters = 200 if n * N <= 10**6 else 20
    ms = cuda_ms(lambda: ei_score.eirate(*args), iters)
    kernel_ms = device_ms(lambda: ei_score.eirate(*args), "eirate_kernel", iters)
    plain_ms = cuda_ms(lambda: ref.eirate_ref(*args), max(iters // 10, 3))
    pairs, fp64, b_ms, b_by = ei_bound(args)
    return dict(case=name, N=N, n=n, membership=layout, member_pairs=pairs,
                fp64_instructions=fp64, max_abs_err=err, ms=ms,
                kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def topk_check(name, args, k, ei_score, ref, timed=True):
    """The top-k kernel against its plain version on the same card inputs:
    values bit-equal and ids equal, every entry; with ``timed``, CUDA-event
    times of both (the wrapper's whole call: checks, buffers, one launch),
    the kernel alone (``kernel_ms``: its device time under torch.profiler;
    ``c_launch_ms``: CUDA events around its C launch only, buffers made
    once) and the bound (the EIrate pass plus kb rounds of compares over
    the padded columns, 8 bytes written per candidate)."""
    got_v, got_i = ei_score.eirate_topk(*args, k=k)
    want_v, want_i = ref.eirate_topk_ref(*args, k=k)
    torch.cuda.synchronize()
    err = float((got_v - want_v).abs().max())
    check(err == 0.0 and torch.equal(got_i, want_i),
          f"eirate_topk {name}: kernel {got_v.tolist()} {got_i.tolist()} vs "
          f"plain {want_v.tolist()} {want_i.tolist()}")
    N, n = args[3].shape
    rec = dict(case=name, N=N, n=n, k=k, max_abs_err=err,
               ids=got_i.tolist(), ids_equal=True)
    if not timed:
        return rec
    bn = min(ref.BLOCK_MODELS, max(n, 1))
    kb = min(k, bn)
    padded = -(-n // bn) * bn
    pairs, fp64, b_ms, b_by = ei_bound(args, extra_ops=kb * padded,
                                       out_bytes=8 * k)
    iters = 200 if n * N <= 10**6 else 20
    buffers = ei_score.topk_buffers(n, k, args[0].device)

    def c_launch():
        ei_score.topk_launch(*args, k, buffers)

    rec.update(member_pairs=pairs, fp64_instructions=fp64,
               ms=cuda_ms(lambda: ei_score.eirate_topk(*args, k=k), iters),
               kernel_ms=device_ms(c_launch, "eirate_topk_kernel", iters),
               c_launch_ms=cuda_ms(c_launch, iters),
               plain_ms=cuda_ms(lambda: ref.eirate_topk_ref(*args, k=k),
                                max(iters // 10, 3)),
               bound_ms=b_ms, bound_by=b_by)
    return rec


def topk_case(name, N, n, layout, k, rng, dev, ei_score, ref):
    args = ei_inputs(N, n, layout, rng, dev)
    rec = topk_check(name, args, k, ei_score, ref)
    rec["membership"] = layout
    if layout == "tie":
        check(rec["ids"] == list(range(k)),
              f"eirate_topk tie case: ids {rec['ids']}, expected 0..{k - 1}")
    return rec


def classes_inputs(N, n, layout, C, rng, dev):
    """Class-axis EIrate inputs: :func:`ei_inputs` with a (C, n) cost
    matrix cost / rate_c + overhead_c built on the card as the control
    plane builds it (by tensors).  ``"c1"`` is one class at rate 1 and
    overhead 0 over disjoint membership; ``"gate"`` puts +inf (the
    registry's memory gate) at a fifth of row 1."""
    mu, sg, best, mem, cost, sel = ei_inputs(
        N, n, "disjoint" if layout in ("c1", "gate") else layout, rng, dev)
    if layout == "c1":
        rates, overs = np.ones(C, np.float32), np.zeros(C, np.float32)
    else:
        rates = rng.uniform(0.5, 4.0, C).astype(np.float32)
        overs = rng.uniform(0.0, 1.0, C).astype(np.float32)
    rates_t, overs_t = (torch.from_numpy(a).to(dev) for a in (rates, overs))
    cm = cost[None, :] / rates_t[:, None] + overs_t[:, None]
    if layout == "gate":
        cm[1, torch.from_numpy(rng.random(n) < 0.2).to(dev)] = float("inf")
    return [mu, sg, best, mem, cm, sel]


def classes_bound(args):
    """The least time for a class-axis pass: membership N*n bytes, mu,
    sigma and selected 9n, best 4N, the cost matrix read and the scores
    written 8Cn; float32: EI_F32_OPS per member pair with sigma > 0, 2 at
    sigma = 0, a division and a select per (class, column); FP64: ei_fp64().
    Returns (member pairs, FP64 instructions, bound ms, bound_by)."""
    mu, sg, best, mem, cm, _ = args
    N, n = mem.shape
    C = cm.shape[0]
    pairs = int(mem.sum())
    pairs_pos = int(mem[:, sg > 0].sum())
    nbytes = N * n + 9 * n + 4 * N + 8 * C * n
    ops = pairs_pos * EI_F32_OPS + (pairs - pairs_pos) * 2 + 2 * C * n
    fp64 = ei_fp64(mu, sg, best, mem)
    return (pairs, fp64) + bound_ms(nbytes, ops, fp64)


def classes_check(name, args, ei_score, ref, timed=True):
    """The class-axis kernel against its plain version on the same card
    inputs (bit-equal), every row against the EIrate kernel run with that
    cost row (bit-equal where the cost is finite, -1e30 where not), and at
    C = 1 the first argmax against the EIrate kernel's; with ``timed``,
    CUDA-event times of both and the bound."""
    mu, sg, best, mem, cm, sel = args
    got = ei_score.eirate_classes(*args)
    want = ref.eirate_classes_ref(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err == 0.0 and torch.equal(got, want),
          f"eirate_classes {name}: kernel and plain version differ by {err}")
    for c in range(cm.shape[0]):
        finite = torch.isfinite(cm[c])
        row = ei_score.eirate(mu, sg, best, mem,
                              torch.where(finite, cm[c], 1.0), sel)
        check(torch.equal(got[c][finite], row[finite])
              and bool((got[c][~finite] == ref.NEG_LARGE).all()),
              f"eirate_classes {name}: row {c} differs from eirate")
    if cm.shape[0] == 1:
        check(int(torch.argmax(got[0])) == int(torch.argmax(row)),
              f"eirate_classes {name}: first argmax differs from eirate's")
    N, n = mem.shape
    rec = dict(case=name, C=cm.shape[0], N=N, n=n, max_abs_err=err,
               rows_equal_eirate=True,
               inf_costs=int((~torch.isfinite(cm)).sum()))
    if not timed:
        return rec
    pairs, fp64, b_ms, b_by = classes_bound(args)
    iters = 200 if n * N <= 10**6 else 20
    rec.update(member_pairs=pairs, fp64_instructions=fp64,
               ms=cuda_ms(lambda: ei_score.eirate_classes(*args), iters),
               kernel_ms=device_ms(lambda: ei_score.eirate_classes(*args),
                                   "eirate_classes_kernel", iters),
               plain_ms=cuda_ms(lambda: ref.eirate_classes_ref(*args),
                                max(iters // 10, 3)),
               bound_ms=b_ms, bound_by=b_by)
    return rec


def classes_case(name, C, N, n, layout, rng, dev, ei_score, ref):
    args = classes_inputs(N, n, layout, C, rng, dev)
    rec = classes_check(name, args, ei_score, ref)
    rec["membership"] = layout
    if layout == "tie":
        got = ei_score.eirate_classes(*args)
        check(bool((got == got[:, :1]).all())
              and all(int(torch.argmax(r)) == 0 for r in got),
              "eirate_classes tie case: equal inputs must give equal rows")
    return rec


def readout_case(k, n, emit_sd, rng, dev, gp_readout, ref, offset=None, width=None):
    """The readout kernel against its plain version, bit for bit, with its
    times; ``offset``: W is columns [offset, offset + n) of a (k, width)
    buffer (default n + 8; a shard's column slice), which takes 16-byte
    copies only where its rows start 16-byte aligned.  The path is the one
    the wrapper counted a launch on."""
    if offset is None:
        width = n
    elif width is None:
        width = n + 8
    W = torch.from_numpy((rng.standard_normal((k, width)) * 0.3).astype(np.float32)).to(dev)
    if offset is not None:
        W = W[:, offset:offset + n]
    alpha = torch.from_numpy(rng.standard_normal(k).astype(np.float32)).to(dev)
    mu0 = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    kd = (W * W).sum(0) + torch.rand(n, device=dev)
    gp_readout.reset_launches()
    got = gp_readout.gp_readout(W, alpha, mu0, kd, emit_sd=emit_sd)
    taken = [p for p, c in gp_readout.launches_by_path.items() if c]
    check(gp_readout.launches == 1 and len(taken) == 1,
          f"gp_readout ({k}, {n}): one call counted {gp_readout.launches} "
          f"launches, by path {gp_readout.launches_by_path}")
    want = ref.gp_readout_ref(W, alpha, mu0, kd, emit_sd=emit_sd)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(err == 0.0, f"gp_readout ({k}, {n}): kernel and plain version "
                      f"differ by {err}")
    if k == 0:
        check(torch.equal(got[0], mu0), "gp_readout k = 0 must give mu = mu0")
    iters = 200 if k * n <= 10**6 else 20
    ms = cuda_ms(lambda: gp_readout.gp_readout(W, alpha, mu0, kd, emit_sd=emit_sd), iters)
    kernel_ms = device_ms(lambda: gp_readout.gp_readout(W, alpha, mu0, kd, emit_sd=emit_sd),
                          "gp_readout_kernel", iters)
    plain_ms = cuda_ms(lambda: ref.gp_readout_ref(W, alpha, mu0, kd, emit_sd=emit_sd),
                       max(iters // 10, 3))
    nbytes = 4 * (k * n + k + 4 * n)
    b_ms, b_by = bound_ms(nbytes, 4 * k * n + 3 * n)
    return dict(case=f"k{k}_n{n}" + ("_sd" if emit_sd else "")
                + ("" if offset is None else f"_slice{offset}_of{width}"), k=k, n=n,
                emit_sd=emit_sd, offset=offset, width=width, path=taken[0],
                max_abs_err=err, ms=ms,
                kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def launch_floor_ms() -> float:
    """The device time of an empty kernel launched as the readout's slab
    kernel is (one block of 256 threads; empty_probe), under the same
    profiler window as the kernels alone: the least any launch takes,
    beside which a readout of a few KB is read."""
    return device_ms(empty_launch, "empty_kernel", 200)


# ---- episodes -----------------------------------------------------------------

def episode(name, problem, policy, M, horizon, counters, simulate, regret_curves):
    """One episode on the card with the launch counts of exactly that run,
    then the same episode on the CPU (plain versions); trial sequences must
    be equal."""
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    gpu = simulate(problem, policy, num_devices=M, seed=0, horizon=horizon,
                   device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    t0 = time.perf_counter()
    cpu = simulate(problem, policy, num_devices=M, seed=0, horizon=horizon,
                   device="cpu")
    cpu_wall = time.perf_counter() - t0
    check(gpu.trials == cpu.trials,
          f"{name}: the card's trial sequence differs from the CPU's")
    check(all(0 <= t.model < problem.num_models for t in gpu.trials)
          and all(t.z is None or np.isfinite(t.z) for t in gpu.trials),
          f"{name}: malformed trial log")
    curves = regret_curves(gpu)
    check(bool(np.isfinite(curves.cumulative).all()), f"{name}: non-finite regret")
    return gpu, dict(
        phase=name, problem=problem.name, policy=policy, num_devices=M,
        horizon=finite(horizon), trials=len(gpu.trials), decisions=gpu.decisions,
        mean_decision_ms=gpu.decision_seconds / max(gpu.decisions, 1) * 1e3,
        cpu_mean_decision_ms=cpu.decision_seconds / max(cpu.decisions, 1) * 1e3,
        time_to_regret_0_01=finite(curves.time_to_instantaneous(0.01)),
        wall_s=wall, cpu_wall_s=cpu_wall, launches=launches,
        trials_equal_cpu=True)


# ---- the sharded plane ------------------------------------------------------------

def host_ms(fn, iters: int) -> float:
    """Mean milliseconds per call on the host clock, each call ending in a
    synchronize, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def readout_inputs(rng, dev):
    """readout_decide's service-size inputs: (W, alpha, mu0, kdiag, member,
    cost, best, selected), W (k_obs, n) with 100 models a tenant."""
    k_obs, n, N = READOUT_SHAPE
    W = torch.from_numpy((rng.standard_normal((k_obs, n)) * 0.03)
                         .astype(np.float32)).to(dev)
    alpha = torch.from_numpy(rng.standard_normal(k_obs).astype(np.float32)).to(dev)
    mu0 = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    kd = (W * W).sum(0) + torch.rand(n, device=dev)
    member = np.zeros((N, n), bool)
    member[np.arange(n) * N // n, np.arange(n)] = True      # 100 models a tenant
    cost = rng.uniform(0.3, 3.0, n).astype(np.float32)
    best = torch.from_numpy(rng.normal(0.5, 0.5, N).astype(np.float32)).to(dev)
    sel = torch.from_numpy(rng.random(n) < 0.25).to(dev)
    return W, alpha, mu0, kd, member, cost, best, sel


def readout_decide_phase(rng, dev, ShardedScorer, ops, ref, counters):
    """readout_decide_topk at service size against the unsharded pipeline:
    gp_readout over all of W, EIrate, first argmax (and the flat top-k)."""
    k_obs, n, N = READOUT_SHAPE
    W, alpha, mu0, kd, member, cost, best, sel = readout_inputs(rng, dev)
    mem_t = torch.from_numpy(member).to(dev)
    cost_t = torch.from_numpy(cost).to(dev)

    def unsharded():
        mu, sd = ops.gp_readout(W, alpha, mu0, kd, emit_sd=True)
        return ops.eirate(mu, sd, best, mem_t, cost_t, sel)

    scores = unsharded()
    want = int(torch.argmax(scores))
    want_v, want_i = ref.topk_first(scores, TOPK)
    readout = counters["gp_readout"][0]
    runs = []
    for S in (1, 4):
        for kernel in ("eirate_topk", "eirate"):
            sc = ShardedScorer(S, topk=TOPK, kernel=kernel, device=dev)
            sc.refresh(member, cost)
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            readout.reset_launches()
            v, g = sc.readout_decide_topk(W, alpha, mu0, kd, best, sel)
            torch.cuda.synchronize()
            launches = {name: getattr(mod, attr)
                        for name, (mod, attr) in counters.items()}
            by_path = {p: c for p, c in readout.launches_by_path.items() if c}
            check(int(g[0]) == want and float(v[0]) == float(scores[want]),
                  f"readout_decide S={S} {kernel}: pick ({int(g[0])}, "
                  f"{float(v[0])}) vs unsharded ({want}, {float(scores[want])})")
            check(torch.equal(v, want_v) and torch.equal(g, want_i.long()),
                  f"readout_decide S={S} {kernel}: top-{TOPK} differs")
            check(launches["gp_readout"] == S
                  and launches[kernel] == S
                  and sum(launches.values()) == 2 * S,
                  f"readout_decide S={S} {kernel}: launches {launches}")
            # the whole W's blocks cover the SMs; a shard's slice's do not
            check(by_path == {"bulk" if S == 1 else "bulk_deep": S},
                  f"readout_decide S={S} {kernel}: readout paths {by_path}")
            runs.append(dict(num_shards=S, route=kernel, pick=int(g[0]),
                             value=float(v[0]), ids=g.tolist(),
                             launches=launches, readout_paths=by_path,
                             ms=host_ms(lambda: sc.readout_decide_topk(
                                 W, alpha, mu0, kd, best, sel), 10)))
    return dict(phase="readout_decide", k_obs=k_obs, n=n, N=N, k=TOPK,
                unsharded_pick=want, unsharded_ms=host_ms(
                    lambda: int(torch.argmax(unsharded())), 10),
                runs=runs, equal_unsharded=True)


def churn_trace(plane, decisions, seed, block_chol, draw, counters,
                sync=None):
    """Drive an open-world plane through the seeded tenant trace.

    ``CHURN_TENANTS`` tenants arrive first, each a Matérn-5/2 block of
    ``CHURN_MODELS`` models (the Fig-5 prior, unit costs) with its own
    ground-truth draw from ``seed``'s generator.  ``CHURN_DEVICES`` devices
    take the picks; a trial lasts its cost and then folds its ground-truth
    z.  Every ``CHURN_EVERY`` decisions the oldest tenant with no trial in
    flight retires, a new tenant arrives and ``compact(max_moves=4)`` runs;
    ``CHURN_RESHARD`` reshards mid-trace.  Returns the (tenant, model) picks
    in order and what the phase prints."""
    rng = np.random.default_rng(seed)
    K, L = block_chol(CHURN_MODELS, 0.2, 0.04)
    mu0, cost = np.zeros(CHURN_MODELS), np.ones(CHURN_MODELS)
    truth: dict[int, np.ndarray] = {}       # tenant key -> ground truth
    tid_of: dict[int, int] = {}             # live tenant key -> tenant slot
    key_of: dict[int, int] = {}             # tenant slot -> live tenant key

    def arrive():
        key = len(truth)
        truth[key] = draw(rng, L)
        h = plane.add_tenant(K, mu0, cost)
        tid_of[key], key_of[h.tenant_id] = h.tenant_id, key

    for _ in range(CHURN_TENANTS):
        arrive()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    free = list(range(CHURN_DEVICES))
    pending: list[tuple] = []               # (end, seq, device, model id)
    picks, decide_s, imbalance = [], [], []
    high_water, now, seq, shard_decisions = plane.num_models, 0.0, 0, 0
    while len(picks) < decisions:
        while free and len(picks) < decisions:
            device = free.pop(0)
            shards = plane._layout.num_shards
            t0 = time.perf_counter()
            pick = plane.choose_mdmt()
            if sync is not None:
                sync()
            decide_s.append(time.perf_counter() - t0)
            check(pick is not None, "churn_sharded: the pool ran dry")
            g = pick[0]
            tid = int(np.nonzero(plane.membership[:, g])[0][0])
            key = key_of[tid]
            picks.append((key, g - plane._layout.blocks[tid].start))
            shard_decisions += shards
            plane.record_start(g)
            seq += 1
            heapq.heappush(pending, (now + float(plane.cost[g]), seq, device, g))
            if len(picks) % CHURN_EVERY == 0:
                busy = {key_of[int(np.nonzero(plane.membership[:, m])[0][0])]
                        for *_, m in pending}
                oldest = next(k for k in sorted(tid_of) if k not in busy)
                plane.retire_tenant(tid_of[oldest])
                del key_of[tid_of.pop(oldest)]
                arrive()
                plane.compact(max_moves=4)
                imbalance.append(plane._layout.imbalance())
                high_water = max(high_water, plane.num_models)
            if len(picks) in CHURN_RESHARD:
                remap = plane.reshard(CHURN_RESHARD[len(picks)])
                pending = [(e, q, d, remap[m]) for e, q, d, m in pending]
                heapq.heapify(pending)
        end, _, device, g = heapq.heappop(pending)
        now = end
        tid = int(np.nonzero(plane.membership[:, g])[0][0])
        local = g - plane._layout.blocks[tid].start
        plane.record_observation(g, float(truth[key_of[tid]][local]))
        free.append(device)
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    return picks, dict(
        decisions=len(picks), mean_decision_ms=float(np.mean(decide_s)) * 1e3,
        live_models_high_water=high_water, capacity=plane.capacity,
        shard_capacity=plane._layout.shard_capacity,
        imbalance_after_compaction_last=imbalance[-1],
        imbalance_after_compaction_max=max(imbalance),
        tenants_admitted=len(truth), shard_decisions=shard_decisions,
        launches=launches)


def churn_phase(seed, dev, ControlPlane, block_chol, draw, counters, ei_score,
                ref):
    """Runs (a)-(e) on the card and (a) on the CPU; equal picks."""
    sync = torch.cuda.synchronize

    def plane(scorer, S, kernel="eirate_topk", device=dev):
        return ControlPlane(np.random.default_rng(seed), scorer=scorer,
                            num_shards=S, shard_topk=TOPK, score_kernel=kernel,
                            model_capacity=1024, tenant_capacity=16,
                            device=device)

    runs, picks = {}, {}
    # (e) is (d)'s twin: one shard is another index space from the start
    # (fresh tenants tie exactly, and the lowest global id wins), so (d) is
    # held to the ops plane at the same shard counts, all the way through
    specs = (("a", "sharded", 4, "eirate_topk"), ("b", "sharded", 4, "eirate"),
             ("c", "ops", 4, "eirate_topk"), ("d", "sharded", 1, "eirate_topk"),
             ("e", "ops", 1, "eirate_topk"))
    for name, scorer, S, kernel in specs:
        cp = plane(scorer, S, kernel)
        t0 = time.perf_counter()
        picks[name], runs[name] = churn_trace(cp, CHURN_DECISIONS, seed,
                                              block_chol, draw, counters, sync)
        runs[name].update(scorer=scorer, num_shards=S, route=kernel,
                          device=str(dev), wall_s=time.perf_counter() - t0)
        if name == "a":
            plane_a = cp
    t0 = time.perf_counter()
    picks["cpu"], runs["cpu"] = churn_trace(
        plane("sharded", 4, device="cpu"), CHURN_CPU_DECISIONS, seed,
        block_chol, draw, counters)
    runs["cpu"].update(scorer="sharded", num_shards=4, route="eirate_topk",
                       device="cpu", wall_s=time.perf_counter() - t0)
    check(picks["b"] == picks["a"], "churn_sharded: route eirate picked differently")
    check(picks["c"] == picks["a"], "churn_sharded: scorer ops picked differently")
    check(picks["cpu"] == picks["a"][:len(picks["cpu"])],
          "churn_sharded: the CPU twin picked differently")
    check(picks["d"] == picks["e"],
          "churn_sharded: sharded at S = 1 picked differently from ops at S = 1")
    d_prefix = next((i for i, (x, y) in enumerate(zip(picks["d"], picks["a"]))
                     if x != y), len(picks["d"]))
    la = runs["a"]["launches"]
    check(la["eirate_topk"] == runs["a"]["shard_decisions"] and la["eirate"] == 0
          and la["gp_readout"] > 0,
          f"churn_sharded (a): {la} for {runs['a']['shard_decisions']} "
          f"shard-decisions")
    check(runs["b"]["launches"]["eirate"] == runs["b"]["shard_decisions"],
          f"churn_sharded (b): launches {runs['b']['launches']}")
    for name in "ce":
        check(runs[name]["launches"]["eirate"] == CHURN_DECISIONS
              and runs[name]["launches"]["eirate_topk"] == 0,
              f"churn_sharded ({name}): launches {runs[name]['launches']}")
    check(runs["d"]["launches"]["eirate_topk"] == runs["d"]["shard_decisions"],
          f"churn_sharded (d): launches {runs['d']['launches']}")
    check(all(v == 0 for v in runs["cpu"]["launches"].values()),
          "churn_sharded: the CPU twin launched a kernel")
    # the top-k kernel on the very inputs run (a) gives each shard
    sc = plane_a._sharded
    mu, var = plane_a.gp.posterior_host()
    mus = sc._per_shard(sc._pad(mu, 0.0, np.float32))
    sds = sc._per_shard(sc._pad(np.sqrt(var), 0.0, np.float32))
    sels = sc._per_shard(sc._pad(plane_a.selected, True, bool))
    bests = sc._replicated(plane_a._best_t)
    shard_cases = [topk_check(f"churn_shard{s}", [mus[s], sds[s], bests[s],
                                                  sc._member[s], sc._cost[s],
                                                  sels[s]], TOPK, ei_score,
                              ref, timed=(s == 0))
                   for s in range(sc.num_shards)]
    return runs, dict(
        phase="churn_sharded", seed=seed, tenants=CHURN_TENANTS,
        models_per_tenant=CHURN_MODELS, devices=CHURN_DEVICES,
        churn_every=CHURN_EVERY, reshard_at=CHURN_RESHARD,
        cpu_decisions=len(picks["cpu"]),
        picks_equal={"b_a": True, "c_a": True, "cpu_a": len(picks["cpu"]),
                     "d_e": True},
        d_a_common_prefix=d_prefix,
        runs=runs, main_path_inputs=shard_cases)


# ---- the elastic device plane ----------------------------------------------------

def watched(DevPlaneEngine):
    """``DevPlaneEngine`` plus what the phase reads and the engine does not
    keep: the high-water mark of live models, the scoring passes that found
    the pool empty (they launch nothing: ``choose_mdmt_batch``'s early-out)
    and a copy of the inputs the class-axis kernel was given in the pass
    with the most classes, taken again whenever the live pool has grown by
    a tenth.  Observation only."""

    class Watched(DevPlaneEngine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.live_high_water = 0
            self.dry_passes = 0
            self.kernel_inputs = None
            self._captured_at = (0, 0)      # (classes, live models)
            plane, batch = self.cp, self.cp.choose_mdmt_batch

            def counted(rates, overheads, k, **kw):
                dry = bool(plane.selected.all())
                out = batch(rates, overheads, k, **kw)
                self.dry_passes += dry
                classes, live = len(rates), plane.num_models
                if not dry and plane.scorer == "ops" and (
                        classes > self._captured_at[0]
                        or (classes == self._captured_at[0]
                            and live > 1.1 * self._captured_at[1])):
                    self._captured_at = (classes, live)
                    mu, sd = plane.gp.posterior_sd()   # flushed: no launch
                    r, o = (torch.from_numpy(np.asarray(a, np.float32))
                            .to(plane.device) for a in (rates, overheads))
                    self.kernel_inputs = [
                        mu, sd, plane._best_t.clone(),
                        plane._membership_t.clone(),
                        plane._cost_t[None, :] / r[:, None] + o[:, None],
                        plane._selected_t.clone()]
                return out

            plane.choose_mdmt_batch = counted

        def _post_event(self, kind):
            self.live_high_water = max(self.live_high_water,
                                       self.cp.num_models)
            super()._post_event(kind)

    return Watched


def trial_rows(res, fields=None):
    rows = [dataclasses.astuple(t) for t in res.trials]
    return rows if fields is None else [r[:fields] for r in rows]


def devplane_phase(dev, counters, DevPlaneEngine, two_class_registry, stream,
                   ei_score, ref):
    """Runs (a)-(e) on the card and (a)'s prefix on the CPU; equal trials."""
    Watched = watched(DevPlaneEngine)
    trace = stream.device_churn_trace(**DEVPLANE_TRACE)
    # the homogeneous fleet's joins come at its one rate; the same seeds
    # give the same events otherwise
    homog = stream.device_churn_trace(
        **{**DEVPLANE_TRACE, "join_classes": (("fast", 16, 1.0),)})

    def engine(device, speed=2.0, overhead=0.5, **kw):
        # every run lays its index space out in DEVPLANE_SHARDS shard spans,
        # the sharded scorer's layout: the layout is part of the tie-break
        # order (fresh tenants tie exactly), so equal picks need equal spans
        reg = two_class_registry(speed, overhead=overhead)
        return Watched(reg.build_fleet(list(DEVPLANE_FLEET)), "mdmt", seed=0,
                       registry=reg, launch_order="fastest",
                       max_live_models=DEVPLANE_MAX_LIVE,
                       num_shards=DEVPLANE_SHARDS, device=device, **kw)

    def run(name, eng, tr, **kw):
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        res = eng.run(tr, **kw)
        if eng.cp.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = res.telemetry.summary()
        return res, dict(
            run=name, scorer=eng.cp.scorer, assign=eng.assign,
            device=str(eng.cp.device), trials=len(res.trials),
            policy_launches=res.policy_launches,
            scoring_passes=eng._scoring_passes, dry_passes=eng.dry_passes,
            mean_decision_ms_per_policy_launch=(
                res.decision_seconds / max(res.policy_launches, 1) * 1e3),
            mean_decision_ms_per_pass=(
                res.decision_seconds / max(eng._scoring_passes, 1) * 1e3),
            events=eng.event_index, live_models_high_water=eng.live_high_water,
            devices_joined=s["devices_joined"], devices_left=s["devices_left"],
            trials_preempted=s["trials_preempted"],
            launches={k: getattr(mod, attr)
                      for k, (mod, attr) in counters.items()},
            wall_s=wall)

    runs, results = {}, {}
    eng_a = engine(dev)
    results["a"], runs["a"] = run("a", eng_a, trace)
    eng_b = engine(dev, scorer="sharded")
    results["b"], runs["b"] = run("b", eng_b, trace)
    results["c"], runs["c"] = run("c", engine(dev, 1.0, 0.0), homog)
    results["d"], runs["d"] = run("d", engine(dev, 1.0, 0.0,
                                             assign="sequential"), homog)

    # (e): durable log + snapshots, a crash halfway, recovery, resume
    work = ROOT / "build" / "chip_smoke" / "devplane"
    shutil.rmtree(work, ignore_errors=True)
    crash_at = eng_a.event_index // 2
    eng_e = engine(dev, log=stream.EventLog(work / "log"),
                   snapshot_root=str(work / "snap"),
                   snapshot_every=DEVPLANE_SNAPSHOT_EVERY,
                   fault=stream.FaultInjector(crash_at))
    t0 = time.perf_counter()
    try:
        eng_e.run(trace)
        crashed = False
    except stream.SimulatedCrash:
        crashed = True
    eng_e.log.close()
    check(crashed, f"devplane_churn (e): no crash at event {crash_at}")
    log = stream.EventLog.load(work / "log")
    rec_e, step = stream.recover(lambda: engine(dev), str(work / "snap"), log)
    results["e"] = rec_e.resume()
    torch.cuda.synchronize()
    runs["e"] = dict(run="e", crash_at=crash_at, resumed_from=step,
                     snapshots=len(list((work / "snap").glob("step_*"))),
                     trials=len(results["e"].trials),
                     wall_s=time.perf_counter() - t0)
    shutil.rmtree(work, ignore_errors=True)

    results["cpu"], runs["cpu"] = run("cpu", engine("cpu"), trace,
                                      horizon=DEVPLANE_CPU_HORIZON)
    runs["cpu"]["horizon"] = finite(DEVPLANE_CPU_HORIZON)

    a = trial_rows(results["a"])
    check(trial_rows(results["b"]) == a,
          "devplane_churn: the sharded scorer's trials differ from (a)")
    check(trial_rows(results["e"]) == a,
          "devplane_churn: the recovered run's trials differ from (a)")
    check(trial_rows(results["c"]) == trial_rows(results["d"]),
          "devplane_churn: batched and sequential differ on the "
          "homogeneous fleet")
    # the twin stopped at its horizon: the launches before it (who, where,
    # when) are (a)'s first ones, and (a) launched nothing else before it
    cpu = trial_rows(results["cpu"], fields=6)
    check(cpu == trial_rows(results["a"], fields=6)[:len(cpu)]
          and all(t.start >= DEVPLANE_CPU_HORIZON
                  for t in results["a"].trials[len(cpu):]) and cpu,
          "devplane_churn: the CPU twin's trials differ from (a)")
    for name, shards in (("a", 1), ("b", DEVPLANE_SHARDS), ("c", 1),
                         ("d", 1)):
        r = runs[name]
        la = r["launches"]
        want = shards * (r["scoring_passes"] - r["dry_passes"])
        check(la["eirate_classes"] == want and la["eirate"] == 0
              and la["eirate_topk"] == 0 and la["gp_readout"] > 0,
              f"devplane_churn ({name}): launches {la} for "
              f"{r['scoring_passes']} passes ({r['dry_passes']} dry)")
    check(all(v == 0 for v in runs["cpu"]["launches"].values()),
          "devplane_churn: the CPU twin launched a kernel")
    ra = runs["a"]
    check(ra["devices_joined"] > 0 and ra["devices_left"] > 0
          and ra["trials_preempted"] > 0 and ra["live_models_high_water"]
          >= 1000, f"devplane_churn (a): too little churn {ra}")
    check(runs["d"]["scoring_passes"] > runs["c"]["scoring_passes"],
          "devplane_churn: batched must take fewer passes than sequential")
    check(eng_a.kernel_inputs is not None, "devplane_churn: no inputs kept")
    main_case = classes_check("devplane_a", eng_a.kernel_inputs, ei_score,
                              ref)
    return runs, dict(
        phase="devplane_churn", trace=DEVPLANE_TRACE,
        fleet=DEVPLANE_FLEET, max_live_models=DEVPLANE_MAX_LIVE,
        trials_equal={"b_a": True, "e_a": True, "c_d": True,
                      "cpu_a": len(cpu)},
        runs=runs, main_path_inputs=[main_case])


# ---- the observability planes -----------------------------------------------------

def obs_planes(obs, health=None):
    """A fresh set of every plane of ``repro_torch.obs``, at the streaming
    example's settings (windows of OBS_WINDOW sim-seconds, its SLO)."""
    reg = obs.MetricsRegistry()
    return dict(
        tracer=obs.Tracer(enabled=True), metrics=reg,
        exporter=obs.MetricsExporter(reg, window=OBS_WINDOW),
        health=health or obs.HealthMonitor(slo=OBS_SLO, window=OBS_WINDOW),
        forensics=obs.ForensicsRecorder(),
        accounting=obs.CapacityAccountant(reg, window=OBS_WINDOW))


def alert_records(engine) -> list[dict]:
    return [a.to_record() for a in engine.health.alerts]


def export_keys(records, alerts: bool = True) -> list:
    """The sim-time fields of export records (their metrics hold wall-clock
    histograms), with the alert counts unless ``alerts`` is False (a
    resumed monitor counts only what it re-emits)."""
    return [[r["window"], r["t"], r["event_index"], bool(r.get("final"))]
            + ([r.get("alerts")] if alerts else []) for r in records]


def forensics_errors(name, got: list[dict], want: list[dict]) -> dict:
    """Card records against CPU records: equal keys, winners, candidate ids,
    costs and counterfactuals, and every value (mu, sd, EIrate, EI, margin)
    within OBS_RTOL of the CPU's.  Returns the largest relative difference
    of each."""
    check(len(got) == len(want),
          f"observability {name}: {len(got)} forensics records on the card, "
          f"{len(want)} on the CPU")
    err = {f: 0.0 for f in ("mu", "sd", "eirate", "ei", "margin")}

    def rel(g, w):
        return 0.0 if g == w else abs(g - w) / max(abs(w), 1e-300)

    for g, w in zip(got, want):
        if g.get("record") == "incident":
            check(g == w, f"observability {name}: incident {g} vs {w}")
            continue
        same = {k: g[k] == w[k] for k in ("t", "event_index", "seq", "scorer",
                                          "speed", "device_class",
                                          "uniform_cost")}
        same["ids"] = ([c["model"] for c in g["topk"]]
                       == [c["model"] for c in w["topk"]])
        same["cost"] = ([c["cost"] for c in g["topk"]]
                        == [c["cost"] for c in w["topk"]])
        check(all(same.values()), f"observability {name}: forensics record "
              f"differs from the CPU's: {same}, {g} vs {w}")
        for cg, cw in zip(g["topk"], w["topk"]):
            for f in ("mu", "sd", "eirate", "ei"):
                err[f] = max(err[f], rel(cg[f], cw[f]))
        if w["margin"] is not None:
            err["margin"] = max(err["margin"], abs(g["margin"] - w["margin"])
                                / abs(w["winner"]["eirate"]))
    check(max(err.values()) <= OBS_RTOL,
          f"observability {name}: forensics values off the CPU's by {err}")
    return err


def disabled_sites_us(engine) -> float:
    """Mean µs of the pop loop's per-event plane sites with every plane
    None (``StreamEngine._drain``: forensics, metrics, accounting, health,
    exporter), timed directly over OBS_SITE_ITERS passes."""
    eng = engine

    def sites():
        if eng.forensics is not None:
            eng.forensics.begin_event(0.0, 0)
        if eng.metrics is not None:
            pass
        if eng.accounting is not None:
            eng.accounting.tick(0.0, 0, eng)
        if eng.health is not None:
            eng._health_tick()
        if eng.exporter is not None:
            eng.exporter.tick(0.0, 0)

    for _ in range(500):
        sites()
    t0 = time.perf_counter()
    for _ in range(OBS_SITE_ITERS):
        sites()
    return (time.perf_counter() - t0) / OBS_SITE_ITERS * 1e6


def observability_phase(dev, counters, DevPlaneEngine, two_class_registry,
                        stream, obs, ShardedScorer):
    """(a) every plane on devplane_churn's trace and the streaming example,
    card against CPU and against bare twins; (b) a crash and recovery with
    every plane on; (c) the adversarial health trace; (d) the phased
    sharded decision at readout_decide's size; (e) the planes' cost."""
    import contextlib
    import io
    from repro_torch.examples import health_demo, streaming_service
    from repro_torch.obs import profile
    Watched = watched(DevPlaneEngine)
    trace = stream.device_churn_trace(**DEVPLANE_TRACE)
    t_phase = time.perf_counter()

    def engine(device, **kw):
        # devplane_churn's run (a): batched, ops, DEVPLANE_SHARDS shard spans
        reg = two_class_registry(2.0, overhead=0.5)
        return Watched(reg.build_fleet(list(DEVPLANE_FLEET)), "mdmt", seed=0,
                       registry=reg, launch_order="fastest",
                       max_live_models=DEVPLANE_MAX_LIVE,
                       num_shards=DEVPLANE_SHARDS, device=device, **kw)

    def run(name, eng, tr=trace):
        reset(counters)
        t0 = time.perf_counter()
        res = eng.run(tr)
        if eng.cp.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return res, dict(
            run=name, device=str(eng.cp.device), trials=len(res.trials),
            events=eng.event_index, policy_launches=res.policy_launches,
            scoring_passes=eng._scoring_passes, dry_passes=eng.dry_passes,
            wall_s=wall,
            wall_ms_per_policy_launch=wall / max(res.policy_launches, 1) * 1e3,
            decision_ms_per_policy_launch=(
                res.decision_seconds / max(res.policy_launches, 1) * 1e3),
            launches=read(counters))

    # (a), devplane: bare, the tracer built but disabled, every plane on
    # (card, then CPU)
    runs, results, engines = {}, {}, {}
    for name, device, kw in (
            ("none", dev, {}),
            ("disabled", dev, {"tracer": obs.Tracer(enabled=False)}),
            ("enabled", dev, obs_planes(obs)),
            ("enabled_cpu", "cpu", obs_planes(obs))):
        engines[name] = engine(device, **kw)
        results[name], runs[name] = run(name, engines[name])
    bare = trial_rows(results["none"])
    for name in ("disabled", "enabled", "enabled_cpu"):
        check(trial_rows(results[name]) == bare,
              f"observability (a): run {name}'s trials differ from the bare "
              f"twin's")
    on, cpu = engines["enabled"], engines["enabled_cpu"]
    r = runs["enabled"]
    la = r["launches"]
    check(la["eirate_classes"] == r["scoring_passes"] - r["dry_passes"]
          and la["gp_readout"] > 0 and la["eirate"] == 0
          and la["eirate_topk"] == 0
          and runs["none"]["launches"] == la,
          f"observability (a): launches {la} for {r['scoring_passes']} passes "
          f"({r['dry_passes']} dry), bare {runs['none']['launches']}")
    check(alert_records(on) == alert_records(cpu) and on.health.alerts
          and on.log.alerts == alert_records(on),
          "observability (a): the card's alerts differ from the CPU's")
    check(export_keys(on.exporter.records) == export_keys(cpu.exporter.records),
          "observability (a): export windows differ card against CPU")
    check(on.accounting.samples == cpu.accounting.samples,
          "observability (a): capacity samples differ card against CPU")
    check(on.tracer.signature() == cpu.tracer.signature(),
          "observability (a): span trees differ card against CPU")
    dp_err = forensics_errors("(a) devplane", on.forensics.records,
                              cpu.forensics.records)
    check(sum(1 for f in on.forensics.records if f.get("record") != "incident")
          >= r["scoring_passes"] - r["dry_passes"],
          "observability (a): fewer forensics records than scoring passes")

    # (a), the streaming example's entry point with every plane on (it
    # checks its own bare twin), card and CPU: kernel 2 with the forensics
    # top-4 from its scores; then its engine sharded (kernel 3, decide_topk)
    # against ops, both in 4 shard spans, on the card
    flags = ["--trace", "--health", "--forensics", "--capacity"]
    example = {}
    for device in (str(dev), "cpu"):
        reset(counters)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            eng, res = streaming_service.main(["--device", device] + flags)
        if eng.cp.device.type == "cuda":
            torch.cuda.synchronize()
        example[device] = (eng, res, dict(
            wall_s=time.perf_counter() - t0, launches=read(counters),
            decisions=sum(1 for f in eng.forensics.records
                          if f.get("record") != "incident"),
            bare_twin_identical="bare twin identical=True" in out.getvalue()))
    (ex, exres, exrow), (ecpu, ecres, _) = example[str(dev)], example["cpu"]
    check(trial_rows(exres) == trial_rows(ecres)
          and alert_records(ex) == alert_records(ecpu)
          and export_keys(ex.exporter.records)
          == export_keys(ecpu.exporter.records)
          and ex.accounting.samples == ecpu.accounting.samples
          and exrow["bare_twin_identical"],
          "observability (a): the streaming example on the card differs from "
          "the CPU's")
    check(exrow["launches"]["eirate"] == 2 * exrow["decisions"]
          and exrow["launches"]["eirate_topk"] == 0,
          f"observability (a): the example launched {exrow['launches']} for "
          f"{exrow['decisions']} recorded decisions (planes-on run + bare "
          f"twin: one EIrate launch each)")
    ex_err = forensics_errors("(a) example", ex.forensics.records,
                              ecpu.forensics.records)
    make = streaming_service.engine_factory(
        streaming_service.parser().parse_args(["--device", str(dev)] + flags))
    ex_trace = streaming_service.make_trace(
        streaming_service.parser().parse_args([]))
    shard_runs = {}
    for scorer in ("ops", "sharded"):
        reset(counters)
        eng = make(scorer=scorer, num_shards=DEVPLANE_SHARDS)
        res = eng.run(ex_trace)
        torch.cuda.synchronize()
        shard_runs[scorer] = (eng, res, read(counters))
    (so, sores, sola), (ss, ssres, ssla) = shard_runs["ops"], shard_runs["sharded"]
    ss_decisions = sum(1 for f in ss.forensics.records
                       if f.get("record") != "incident")
    check(trial_rows(sores) == trial_rows(ssres)
          and [f["winner"]["model"] for f in so.forensics.records]
          == [f["winner"]["model"] for f in ss.forensics.records]
          and alert_records(so) == alert_records(ss),
          "observability (a): sharded and ops differ with every plane on")
    check(ssla["eirate_topk"] == DEVPLANE_SHARDS * ss_decisions
          and ssla["eirate"] == 0 and sola["eirate_topk"] == 0,
          f"observability (a): sharded launches {ssla} for {ss_decisions} "
          f"decisions, ops {sola}")

    # (b): (a)'s run with every plane on, durable, crashed halfway,
    # recovered and resumed
    work = ROOT / "build" / "chip_smoke" / "observability"
    shutil.rmtree(work, ignore_errors=True)
    crash_at = on.event_index // 2
    eng_b = engine(dev, log=stream.EventLog(work / "log"),
                   snapshot_root=str(work / "snap"),
                   snapshot_every=DEVPLANE_SNAPSHOT_EVERY,
                   fault=stream.FaultInjector(crash_at), **obs_planes(obs))
    t0 = time.perf_counter()
    try:
        eng_b.run(trace)
        crashed = False
    except stream.SimulatedCrash:
        crashed = True
    eng_b.log.close()
    check(crashed, f"observability (b): no crash at event {crash_at}")
    durable = stream.EventLog.load(work / "log")
    rec_b, step = stream.recover(lambda **kw: engine(dev, **obs_planes(obs),
                                                     **kw),
                                 str(work / "snap"), durable)
    res_b = rec_b.resume()
    torch.cuda.synchronize()
    suffix = alert_records(rec_b)
    check(trial_rows(res_b) == bare, "observability (b): the recovered run's "
          "trials differ")
    check([a for a in durable.alerts if a["event_index"] <= step] + suffix
          == alert_records(on) and rec_b.log.alerts == suffix,
          "observability (b): durable alerts + the re-emitted suffix differ "
          "from the uninterrupted run's")
    check(export_keys(rec_b.exporter.records, alerts=False)
          == [k for k in export_keys(on.exporter.records, alerts=False)
              if k[2] > step],
          "observability (b): the replayed export windows differ")
    check(rec_b.forensics.records
          == [f for f in on.forensics.records if f["event_index"] > step],
          "observability (b): the replayed forensics records differ")
    check(rec_b.accounting.samples
          == [s for s in on.accounting.samples if s["event_index"] > step],
          "observability (b): the replayed capacity samples differ")
    sig = on.tracer.signature(min_trace=step + 1)
    check(sig and rec_b.tracer.signature(min_trace=step + 1) == sig,
          "observability (b): the replayed span tree differs")
    crash = dict(crash_at=crash_at, resumed_from=step,
                 alerts_prefix=len(alert_records(on)) - len(suffix),
                 alerts_suffix=len(suffix),
                 export_windows_suffix=len(rec_b.exporter.records),
                 forensics_suffix=len(rec_b.forensics.records),
                 wall_s=time.perf_counter() - t0)
    shutil.rmtree(work, ignore_errors=True)

    # (c): the adversarial trace on the card, every ALERT_KINDS entry
    reset(counters)
    hd, hdres, _ = health_demo.run(dev)
    torch.cuda.synchronize()
    hd_launches = read(counters)
    hd_cpu, hd_cpu_res, _ = health_demo.run("cpu")
    fired = sorted({a.kind for a in hd.health.alerts})
    check(fired == sorted(obs.ALERT_KINDS),
          f"observability (c): fired {fired}, not every one of "
          f"{obs.ALERT_KINDS}")
    check(alert_records(hd) == alert_records(hd_cpu)
          and trial_rows(hdres) == trial_rows(hd_cpu_res),
          "observability (c): the card's alerts differ from the CPU's")
    hd_err = forensics_errors("(c)", hd.forensics.records,
                              hd_cpu.forensics.records)

    # (d): the phased decision at readout_decide's service size, S = 4
    W, alpha, mu0, kd, member, cost, best, sel = readout_inputs(
        np.random.default_rng(1), dev)
    phased = {}
    for kernel in ("eirate_topk", "eirate"):
        sc = ShardedScorer(DEVPLANE_SHARDS, topk=TOPK, kernel=kernel,
                           device=dev)
        sc.refresh(member, cost)
        v, g = sc.readout_decide_topk(W, alpha, mu0, kd, best, sel)
        sc.tracer = obs.Tracer(enabled=True)
        reset(counters)
        pv, pg = sc.readout_decide_topk_phased(W, alpha, mu0, kd, best, sel)
        la = read(counters)
        spans = [s["name"] for s in sc.tracer.records()]
        check(torch.equal(v, pv) and torch.equal(g, pg),
              f"observability (d) {kernel}: the phased pick "
              f"({int(pg[0])}) differs from the fused one ({int(g[0])})")
        check(spans == ["readout", "score_topk", "gather_pick"],
              f"observability (d) {kernel}: spans {spans}")
        check(la["gp_readout"] == DEVPLANE_SHARDS
              and la[kernel] == DEVPLANE_SHARDS
              and sum(la.values()) == 2 * DEVPLANE_SHARDS,
              f"observability (d) {kernel}: launches {la}")
        span_us = {s["name"]: s["dur_us"] for s in sc.tracer.records()}
        sc.tracer = obs.NULL_TRACER
        times = sc.phase_times(W, alpha, mu0, kd, best, sel, iters=20,
                               warmup=3)
        phased[kernel] = dict(pick=int(pg[0]), launches=la, spans=spans,
                              phase_times_us=times, first_call_span_us=span_us)
    prof = None
    if profile.profiler_available():
        prof = profile.capture_call(
            lambda: sc.readout_decide_topk_phased(W, alpha, mu0, kd, best,
                                                  sel),
            ROOT / "build" / "chip_smoke" / "profile", iters=3)

    # (e): the planes' cost per decision (policy launch), from (a)'s runs;
    # the reference's target for the disabled stack, under 1% of a
    # decision, is reported, not gated: host clocks spread about 2x between
    # calls
    sites_us = disabled_sites_us(engines["none"])
    base = runs["none"]["wall_ms_per_policy_launch"]
    cost = {name: dict(wall_ms_per_policy_launch=runs[name][
                           "wall_ms_per_policy_launch"],
                       decision_ms_per_policy_launch=runs[name][
                           "decision_ms_per_policy_launch"],
                       over_bare=runs[name]["wall_ms_per_policy_launch"] / base)
            for name in ("none", "disabled", "enabled")}
    cost["disabled_sites_us_per_event"] = sites_us
    cost["disabled_sites_share_of_a_decision"] = (
        sites_us * 1e-3 / runs["none"]["decision_ms_per_policy_launch"])
    cost["target_share"] = 0.01
    cost["decisions_changed"] = 0
    launches = [r["launches"] for r in runs.values()] + [
        exrow["launches"], sola, ssla, hd_launches] + [
        p["launches"] for p in phased.values()]
    return dict(
        phase="observability", card=card_name_and_power(),
        trace=DEVPLANE_TRACE, window=OBS_WINDOW, slo=OBS_SLO,
        devplane=dict(runs=runs, alerts=len(alert_records(on)),
                      alert_kinds=sorted({a.kind for a in on.health.alerts}),
                      export_windows=len(on.exporter.records),
                      capacity_samples=len(on.accounting.samples),
                      forensics_records=len(on.forensics.records),
                      spans=len(on.tracer.records()),
                      forensics_max_rel_err=dp_err),
        example=dict(wall_s=exrow["wall_s"], launches=exrow["launches"],
                     decisions=exrow["decisions"],
                     alerts=len(alert_records(ex)),
                     forensics_max_rel_err=ex_err,
                     sharded_launches=ssla, sharded_decisions=ss_decisions),
        crash=crash,
        health_demo=dict(alert_kinds=fired, alerts=len(alert_records(hd)),
                         launches=hd_launches, forensics_max_rel_err=hd_err),
        phased=phased, profile=prof, cost=cost,
        launches={k: sum(la[k] for la in launches) for k in counters},
        forensics_max_rel_err=max(max(e.values())
                                  for e in (dp_err, ex_err, hd_err)),
        phase_s=time.perf_counter() - t_phase)


# ---- the JAX package's service suites ---------------------------------------------

#: the port's service suites (repro_torch.benchmarks), in the phase's order,
#: each with the kernels it must launch on the card
SUITE_KERNELS = {
    "control": ("eirate", "gp_readout"),
    "stream": ("eirate", "eirate_topk", "gp_readout"),
    "shard": ("eirate_topk", "gp_readout"),
    "devchurn": ("eirate_classes", "gp_readout"),
    "eventlog": ("eirate", "gp_readout"),
    "dtrace": ("eirate_topk", "gp_readout"),
    "obs": ("eirate_topk", "gp_readout"),
    "capacity": ("eirate_topk", "gp_readout"),
    "chaos": ("eirate_classes", "gp_readout"),
}


def suites_phase(dev, counters):
    """The service suites on the card: (a) each at the smoke shapes
    (BENCH_FAST) on the card and on the CPU, rows equal less their host
    times; (b) each at the reference's full shapes on the card, its
    BENCH_torch_<suite>.json written to a temporary directory and every row
    printed, the reference's gates asserted inside the sections; (c)
    ``regress`` on (b)'s payloads: each against itself flags nothing, a
    copy with its slowest row doubled flags that row, a copy stamped with
    another device kind is an environment mismatch."""
    import contextlib
    import importlib
    import io
    import tempfile
    from repro_torch.benchmarks import common as bench
    from repro_torch.benchmarks import regress
    from repro_torch.benchmarks import run as bench_run

    mods = {s: importlib.import_module(f"repro_torch.benchmarks.{bench_run.MODULES[s]}")
            for s in SUITE_KERNELS}
    t_phase = time.perf_counter()

    def launched(section, launches, what):
        missing = [k for k in SUITE_KERNELS[section] if launches[k] == 0]
        check(not missing, f"suites {what}: {section} launched none of {missing} "
              f"(launches {launches})")

    # (a) smoke shapes, card against CPU
    smoke = {}
    bench.set_fast(True)
    for section, mod in mods.items():
        reset(counters)
        t0 = time.perf_counter()
        card = bench_run.comparable(section, bench.capture_rows(mod.main, device=dev))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = read(counters)
        t0 = time.perf_counter()
        cpu = bench_run.comparable(section, bench.capture_rows(mod.main, device="cpu"))
        cpu_s = time.perf_counter() - t0
        check(card == cpu, f"suites (a): {section}'s rows on the card {card} "
              f"differ from the CPU's {cpu}")
        launched(section, launches, "(a)")
        smoke[section] = dict(rows=len(card), card_s=card_s, cpu_s=cpu_s,
                              launches=launches)

    # (b) the reference's full shapes on the card
    full = {}
    bench.set_fast(False)
    out_dir = Path(tempfile.mkdtemp(prefix="bench_torch_"))
    try:
        for section, mod in mods.items():
            reset(counters)
            bench.begin_suite(bench_run.SUITE_NAMES[section])
            t0 = time.perf_counter()
            try:
                rows = bench.capture_rows(mod.main, device=dev)
            except BaseException:
                bench.abort_suite()
                raise
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            path = bench.end_suite(out_dir)
            launches = read(counters)
            launched(section, launches, "(b)")
            payload = json.loads(path.read_text())
            env = payload["environment"]
            check(payload["schema_version"] == 1 and env["fast"] is False
                  and env["device_kind"] == torch.cuda.get_device_name(0)
                  and env["device_count"] == torch.cuda.device_count()
                  and env["power_limit"] != "none",
                  f"suites (b): {path.name}'s stamp {env}")
            full[section] = dict(
                suite=payload["suite"], seconds=seconds, launches=launches,
                rows=[dict(name=n, us_per_call=us, derived=dict(d))
                      for n, us, d in rows])

        # (c) regress on (b)'s payloads
        verdicts = {}
        for path in sorted(out_dir.glob("BENCH_torch_*.json")):
            payload = regress.load_suite(path)
            same = regress.compare_suites(payload, payload, threshold=1.5,
                                          min_us=1.0, allow_legacy=False)
            slowest = max(payload["rows"],
                          key=lambda n: payload["rows"][n]["us_per_call"])
            doubled = json.loads(path.read_text())
            doubled["rows"][slowest]["us_per_call"] *= 2
            flagged = regress.compare_suites(payload, doubled, threshold=1.5,
                                             min_us=1.0, allow_legacy=False)
            other = json.loads(path.read_text())
            other["environment"]["device_kind"] = "another card"
            moved = regress.compare_suites(payload, other, threshold=1.5,
                                           min_us=1.0, allow_legacy=False)
            regressed = [r["name"] for r in flagged["rows"]
                         if r["status"] == "regression"]
            check(same["status"] == "ok"
                  and all(r["status"] == "ok" for r in same["rows"])
                  and flagged["status"] == "regression" and regressed == [slowest]
                  and moved["status"] == "skipped"
                  and "device_kind" in moved["reason"],
                  f"suites (c): regress on {path.name}: itself {same['status']}, "
                  f"{slowest} doubled flagged {regressed}, another card "
                  f"{moved['status']}")
            verdicts[payload["suite"]] = dict(doubled_row=slowest,
                                              flagged=regressed)
        report = out_dir / "regress_report.json"
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            rc_same = regress.main(["--check", "--baseline-dir", str(out_dir),
                                    "--fresh-dir", str(out_dir),
                                    "--report", str(report)])
        check(rc_same == 0, f"suites (c): regress --check of a run against itself "
              f"exited {rc_same}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return dict(phase="suites", card=card_name_and_power(),
                smoke=smoke, full=full, regress=verdicts,
                launches={k: sum(r["launches"][k] for r in full.values())
                          for k in counters},
                smoke_launches={k: sum(r["launches"][k] for r in smoke.values())
                                for k in counters},
                phase_s=time.perf_counter() - t_phase)


# ---- the data plane ------------------------------------------------------------

def auto_ms(fn, budget_ms: float = 150.0, max_iters: int = 50) -> float:
    """:func:`cuda_ms` over as many calls as fill about ``budget_ms``
    (3 to ``max_iters``), from one timed call."""
    first = cuda_ms(fn, 1)
    return cuda_ms(fn, int(min(max(budget_ms / max(first, 1e-3), 3), max_iters)))


def bounds(nbytes: float, flops: float, route: str, elementwise: float = 0.0) -> dict:
    """The bound at the card's peak for the route's arithmetic and, beside
    it, the bound at the float32 CUDA-core rate (67 TFLOP/s) for all of it:
    ``flops`` of products at the route's tensor-core peak -- bf16 routes
    ("wgmma", "tensor_cores") at 989 TFLOP/s, the float32 routes of flash
    and the SSD scan ("tf32x3") at three TF32 products for each float32
    product, 3 x flops over 495 TFLOP/s -- and the ``elementwise``
    operations beside them (decay, mask, scale) at the CUDA cores' 67
    TFLOP/s, the two units running at once.  Each the largest of those and
    bytes over 3.35 TB/s."""
    f32_ms = bound_ms(nbytes, flops + elementwise)[0]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if route == "tf32x3":
        t_mma = 3 * flops / TF32_OPS_PER_S * 1e3
        peak = "3 x product flops on the TF32 tensor cores, 495 TFLOP/s"
    else:
        t_mma = flops / BF16_OPS_PER_S * 1e3
        peak = "product flops on the bf16 tensor cores, 989 TFLOP/s"
    peak += "; elementwise on the CUDA cores, 67 TFLOP/s; 3.35 TB/s"
    t_ops = max(t_mma, elementwise / FP32_OPS_PER_S * 1e3)
    b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return dict(bytes=nbytes, flops=flops, elementwise_ops=elementwise, bound_ms=b_ms,
                bound_by=b_by, bound_peak=peak, bound_ms_f32_cuda_cores=f32_ms)


def held(name, got, want, tol=None) -> dict:
    """Holds a kernel's output to its plain version's at ``tol`` (rtol,
    atol as a share of max |want|), by default DATA_TOL of the output's
    dtype; what the case prints of it."""
    rtol, atol_of_max = tol or DATA_TOL[want.dtype]
    g, w = got.float(), want.float()
    scale = float(w.abs().max())
    diff = (g - w).abs()
    err = float(diff.max())
    check(got.dtype == want.dtype and got.shape == want.shape
          and bool(torch.isfinite(g).all()) and scale > 0.0
          and bool((diff <= atol_of_max * scale + rtol * w.abs()).all()),
          f"{name}: kernel and plain version differ by {err} "
          f"(max |want| {scale})")
    return dict(tolerance=dict(rtol=rtol, atol=atol_of_max * scale,
                               atol_of_max_abs_want=atol_of_max),
                max_abs_err=err, max_abs_want=scale,
                err_over_max_abs_want=err / scale)


def flash_check(name, q, k, v, window, flash_mod, ref):
    """The flash kernel against ``ref.attention_ref`` on the same card
    inputs, to DATA_TOL; CUDA-event times of both and of
    scaled_dot_product_attention; the bound counts each input read and the
    output written once, and 4 D flops per unmasked (query, key) pair."""
    route = flash_mod.route(q.dtype)
    before = dict(flash_mod.launches_by_route)
    got = flash_mod.flash_attention(q, k, v, window=window)
    taken = {r: c - before[r] for r, c in flash_mod.launches_by_route.items()}
    check(taken == {r: int(r == route) for r in taken},
          f"flash_attention {name}: {q.dtype} took the routes {taken}, not {route}")
    want = ref.attention_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    agreement = held(f"flash_attention {name}", got, want)
    if route == "wgmma":   # and its arithmetic step for step (P as hi + lo)
        agreement["route_ref"] = held(f"flash_attention {name} (route arithmetic)",
                                      got, ref.attention_wgmma_route_ref(
                                          q, k, v, window=window))
    else:                  # tf32x3: its arithmetic tile for tile, tighter
        agreement["route_ref"] = held(f"flash_attention {name} (route arithmetic)",
                                      got, ref.attention_tf32x3_route_ref(
                                          q, k, v, window=window), ROUTE_TOL_F32)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window is None:
        def library():
            return sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    else:
        pos = torch.arange(S, device=q.device)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)

        def library():
            return sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    lib_err = float((library().transpose(1, 2).float() - want.float()).abs().max())
    rows = np.arange(S)
    pairs = int((rows + 1 if window is None else np.minimum(rows + 1, window)).sum())
    nbytes = q.element_size() * 2 * B * S * D * (Hq + Hkv)
    rec = dict(case=name, B=B, S=S, Hq=Hq, Hkv=Hkv, D=D, window=window,
               dtype=str(q.dtype).replace("torch.", ""), route=route, **agreement,
               unmasked_pairs=pairs * B * Hq,
               ms=auto_ms(lambda: flash_mod.flash_attention(q, k, v, window=window)),
               kernel_ms=device_ms(lambda: flash_mod.flash_attention(q, k, v, window=window),
                                   "flash_sm90_kernel" if route == "wgmma"
                                   else "flash_tf32x3_kernel", 10),
               plain_ms=auto_ms(lambda: ref.attention_ref(q, k, v, window=window),
                                max_iters=5),
               library_ms=auto_ms(library), library_max_abs_err=lib_err)
    rec.update(bounds(nbytes, 4 * D * pairs * B * Hq, route))
    return rec


def ssd_check(name, x, dt, la, b, c, chunk, ssd_mod, ref):
    """The SSD kernels of the inputs' route against ``ref.ssd_ref`` (the
    per-step recurrence) on the same card inputs, to DATA_TOL (the output
    is float32), and against the route's arithmetic step for step too
    (``ref.ssd_chunked_ref`` at DATA_TOL, ``ref.ssd_tf32x3_route_ref`` at
    ROUTE_TOL_F32); CUDA-event times of the call and of
    the plain version (no single PyTorch call computes the scan), and the
    route's kernels alone (device time under torch.profiler).  The bound
    counts each input read and y written once, and the operations this S
    and Q need (:func:`bounds`): the products of the chunked algorithm,
    C B^T once per (batch, chunk) as the heads share it, C in^T only in a
    chunk a state enters and (w x)^T B only in one a state leaves (a
    single chunk runs neither), at the tensor-core peak for x, b and c's
    type, and the elementwise decay, mask and scale at the CUDA cores'."""
    route = ssd_mod.route(x.dtype)
    before = dict(ssd_mod.launches_by_route)
    got = ssd_mod.ssd_mix(x, dt, la, b, c, chunk=chunk)
    taken = {r: n - before[r] for r, n in ssd_mod.launches_by_route.items()}
    check(taken == {r: int(r == route) for r in taken},
          f"ssd {name}: {x.dtype} took the routes {taken}, not {route}")
    want = ref.ssd_ref(x, dt, la, b, c)
    torch.cuda.synchronize()
    agreement = held(f"ssd {name}", got, want)
    kernels = ssd_mod.call_kernels(route, x.shape[1], chunk)
    if route == "tensor_cores":
        agreement["route_ref"] = held(f"ssd {name} (route arithmetic)", got,
                                      ref.ssd_chunked_ref(x, dt, la, b, c, chunk=chunk))
    else:                  # tf32x3: its arithmetic chunk for chunk, tighter
        agreement["route_ref"] = held(f"ssd {name} (route arithmetic)", got,
                                      ref.ssd_tf32x3_route_ref(x, dt, la, b, c, chunk=chunk),
                                      ROUTE_TOL_F32)
    B, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    chunks = [min(Q, S - c0) for c0 in range(0, S, Q)]
    flops = elementwise = 0                  # what this S and Q run, chunk by chunk
    for i, L in enumerate(chunks):
        pairs = L * (L + 1) // 2
        enters, leaves = i > 0, i < len(chunks) - 1   # a state in, a state out
        flops += B * 2 * N * pairs                                  # C B^T
        flops += B * H * pairs * 2 * P                              # W' X
        flops += B * H * L * P * 2 * N * (enters + leaves)          # C in^T, (w x)^T B
        elementwise += B * H * pairs * 3                            # W': decay, dt, mask
        elementwise += B * H * L * P * enters                       # exp(lcum_t) C in^T
        elementwise += B * H * 2 * P * N * (enters and leaves)      # in_{c+1} = a in_c + S_c
    nbytes = (x.element_size() * (B * S * H * P + 2 * B * S * N)
              + 4 * 2 * B * S * H + 4 * B * S * H * P)
    by_kernel = {}
    rec = dict(case=name, B=B, S=S, H=H, P=P, N=N, chunk=Q,
               dtype=str(x.dtype).replace("torch.", ""), route=route,
               kernels=list(kernels), **agreement,
               ms=auto_ms(lambda: ssd_mod.ssd_mix(x, dt, la, b, c, chunk=chunk)),
               kernel_ms=device_ms(lambda: ssd_mod.ssd_mix(x, dt, la, b, c, chunk=chunk),
                                   kernels, 10, by_kernel),
               kernel_ms_by_kernel=by_kernel,
               plain_ms=auto_ms(lambda: ref.ssd_ref(x, dt, la, b, c), max_iters=3),
               library_ms=None)
    rec.update(bounds(nbytes, flops, route, elementwise))
    return rec


def flash_case(name, B, S, Hq, Hkv, D, window, dtype, gen, dev, flash_mod, ref):
    q, k, v = (torch.randn((B, S, h, D), generator=gen, device=dev).to(dtype)
               for h in (Hq, Hkv, Hkv))
    return flash_check(name, q, k, v, window, flash_mod, ref)


def ssd_case(name, B, S, H, P, N, chunk, dtype, gen, dev, ssd_mod, ref):
    """Inputs as the model makes them: dt in [0.001, 0.1], log_a = -dt A
    with A in [0.5, 2]."""
    x = torch.randn((B, S, H, P), generator=gen, device=dev).to(dtype)
    dt = torch.rand((B, S, H), generator=gen, device=dev) * 0.099 + 0.001
    la = -dt * (torch.rand((H,), generator=gen, device=dev) * 1.5 + 0.5)
    b, c = (torch.randn((B, S, N), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    return ssd_check(name, x, dt, la, b, c, chunk, ssd_mod, ref)


def reset(counters) -> None:
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def read(counters) -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}


def tensors_to(tree, device):
    from repro_torch.models.spec import tree_map
    return tree_map(lambda t: t.to(device), tree, lambda x: isinstance(x, torch.Tensor))


def first_layers(params, n: int):
    """The parameters with the first ``n`` entries of the stacked blocks'
    leading axis (layers; a hybrid's groups) (views, no copy)."""
    from repro_torch.models.spec import tree_map
    return {**params, "blocks": tree_map(lambda a: a[:n], params["blocks"],
                                         lambda x: isinstance(x, torch.Tensor))}


def cut_depth(params, cfg, layers: int):
    """(params, cfg) of the first ``layers`` layers: a hybrid's first
    ``layers`` / k groups (``layers`` a multiple of k) and its shared
    block."""
    n = layers // cfg.hybrid_attn_every if cfg.family == "hybrid" else layers
    return first_layers(params, n), dataclasses.replace(cfg, num_layers=layers)


def kernel_route(cfg):
    """``cfg`` with the full-sequence forward on the flash and SSD kernels
    (the configs' default is the plain route, which training takes)."""
    ssm = cfg.ssm._replace(use_pallas=True) if cfg.ssm is not None else None
    return dataclasses.replace(cfg, use_pallas=True, ssm=ssm)


def expected_calls(cfg) -> dict:
    """Kernel calls of one full-sequence forward on the kernel route: a
    flash call per attention layer (a hybrid's shared block once a group)
    and an SSD call per Mamba2 layer, no other kernel."""
    return {"flash_attention": cfg.num_attn_layers,
            "ssd": cfg.num_layers if cfg.ssm is not None else 0}


def model_batch(cfg, B: int, S: int, rng, dev) -> dict:
    """``data.random_batch`` of S positions drawn from ``rng``, on ``dev``."""
    from repro_torch.data import random_batch
    return {k: torch.from_numpy(v).to(dev) for k, v in random_batch(cfg, B, S, rng).items()}


def positions_of(batch: dict) -> int:
    """The positions a batch fills: its sequence input's, and the image's
    patches before them."""
    from repro_torch.data import seq_key
    return batch[seq_key(batch)].shape[1] + (
        batch["patches"].shape[1] if "patches" in batch else 0)


def head_of(batch: dict, B: int, S: int) -> dict:
    """The first B sequences, the first S entries of the sequence input
    (tokens or frames) and its labels; an image's patches whole."""
    from repro_torch.data import seq_key
    key = seq_key(batch)
    return {k: (v[:B, :S] if k in (key, "labels") else v[:B]) for k, v in batch.items()}


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def by_route(flash_mod, ssd_mod) -> dict:
    return dict(flash=dict(flash_mod.launches_by_route),
                ssd=dict(ssd_mod.launches_by_route))


def want_routes(calls: dict, dtype) -> dict:
    """Launches by route for ``calls`` in ``dtype``: bf16 on wgmma and the
    tensor-core SSD route, float32 on both tf32x3 routes."""
    f32 = dtype == torch.float32
    n_flash, n_ssd = calls["flash_attention"], calls["ssd"]
    return dict(flash={"wgmma": 0 if f32 else n_flash, "tf32x3": n_flash if f32 else 0},
                ssd={"tensor_cores": 0 if f32 else n_ssd, "tf32x3": n_ssd if f32 else 0})


def reset_all(counters, flash_mod, ssd_mod) -> None:
    reset(counters)
    flash_mod.reset_launches()
    ssd_mod.reset_launches()


def held_calls(name, counters, calls, dtype, flash_mod, ssd_mod) -> tuple[dict, dict]:
    """The launches since the counters' reset: exactly ``calls`` (no other
    kernel), each on its dtype's route; (launches, by route)."""
    launches = read(counters)
    want = {k: calls.get(k, 0) for k in launches}
    routes = by_route(flash_mod, ssd_mod)
    check(launches == want, f"{name}: launches {launches}, expected {want}")
    check(routes == want_routes(calls, dtype),
          f"{name}: calls by route {routes}, expected {want_routes(calls, dtype)}")
    return launches, routes


@contextlib.contextmanager
def routes_recorded(log: list):
    """Records every MoE routing while it is open: each group's expert ids
    and keep masks, on the host."""
    from repro_torch.models import moe as moe_mod
    route = moe_mod._route

    def recording(w, x, cfg):
        gates, ids, aux = route(w, x, cfg)
        _, keep = moe_mod.dispatch(ids, cfg, cfg.capacity)
        log.append((ids.cpu(), keep.cpu()))
        return gates, ids, aux
    moe_mod._route = recording
    try:
        yield log
    finally:
        moe_mod._route = route


def layer0_cases(arch, params, batch, cfg, flash_mod, ssd_mod, ref) -> dict:
    """Each kernel of the model held against its plain version on the
    inputs the model first gives it: the first Mamba2 layer's SSD inputs;
    the first attention layer's q, k, v (a hybrid's: the shared block's
    first call, after the first group's Mamba2 layers)."""
    from repro_torch.models.attention import _project_qkv
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.model import _ssm_block, embed_inputs
    from repro_torch.models.spec import tree_map
    from repro_torch.models.ssm import mix_inputs

    def index(tree, i):
        return tree_map(lambda a: a[i], tree, lambda t: isinstance(t, torch.Tensor))

    cases = {}
    x, positions = embed_inputs(params, batch, cfg)
    first = index(params["blocks"], 0)              # a layer; a hybrid's group
    if cfg.ssm is not None:
        group = first if cfg.family == "hybrid" else None
        layer = index(group, 0) if group is not None else first
        h = apply_norm(cfg.norm, layer["norm"], x)
        (xh, dt, la, bm, cm, Q), _ = mix_inputs(layer["ssm"], h, cfg.ssm)
        cases["ssd"] = ssd_check(f"layer0_{arch}", xh, dt, la, bm, cm, Q, ssd_mod, ref)
    if not cfg.uses_attention:
        return cases
    if cfg.family == "hybrid":
        for i in range(cfg.hybrid_attn_every):
            x = _ssm_block(index(group, i), x, cfg)
        block, name = params["shared_attn"], f"shared_block_{arch}"
    else:
        block, name = first, f"layer0_{arch}"
    h = apply_norm(cfg.norm, block.get("attn_norm") or None, x)
    q, k, v = _project_qkv(block["attn"], h, cfg.attn_cfg, positions)
    cases["flash_attention"] = flash_check(name, q, k, v, cfg.sliding_window,
                                           flash_mod, ref)
    return cases


def draw_params(cfg, seed: int, dev):
    """``init_params`` with every leaf drawn in the config's
    ``param_dtype``: ``init_from_specs`` gives a spec's own dtype (float32)
    precedence over the field, in the reference as in the port, and draws
    in float32 before a cast.  A cut to bf16 parameters fills each leaf in
    bf16 directly, in ``init_from_specs``' order and distributions, so no
    leaf ever needs its float32 draw whole (arctic's stacked experts would
    take 36 GB more)."""
    from repro_torch.models import init_params, model_specs
    from repro_torch.models.spec import tree_leaves, tree_map
    if cfg.param_dtype == torch.float32:
        return init_params(cfg, seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def fill(s):
        t = torch.empty(s.shape, dtype=cfg.param_dtype, device=dev)
        if s.init in ("zeros", "ones"):
            return t.fill_(float(s.init == "ones"))
        fan_in = s.shape[0] if len(s.shape) == 1 else math.prod(s.shape[:-1])
        std = s.init_scale if s.init == "normal" else 1.0 / math.sqrt(max(fan_in, 1))
        return t.normal_(0.0, std, generator=gen)

    specs = model_specs(cfg)
    filled = {id(s): fill(s) for s in tree_leaves(specs)}
    return tree_map(lambda s: filled[id(s)], specs)


def param_bytes(cfg) -> int:
    return cfg.param_count() * torch.empty((), dtype=cfg.param_dtype).element_size()


def cuts_of(full, cfg) -> list[str]:
    """What ``cfg`` cut of the published ``full``, each with its parameter
    bytes before and after."""
    cuts = []
    if cfg.num_layers != full.num_layers:
        cuts.append(f"num_layers {full.num_layers} -> {cfg.num_layers}")
    if cfg.param_dtype != full.param_dtype:
        cuts.append(f"param_dtype {dtype_name(full.param_dtype)} -> "
                    f"{dtype_name(cfg.param_dtype)} (the config's own field; every "
                    "leaf drawn in it)")
    if cuts:
        cuts.append(f"{full.param_count():,} parameters, {param_bytes(full) / 1e9:.1f} GB "
                    f"-> {cfg.param_count():,}, {param_bytes(cfg) / 1e9:.1f} GB")
    return cuts


def model_forward_phase(arch, seed, dev, counters, cut=None, twin_layers=TWIN_LAYERS,
                        phase="model_forward"):
    """One model at full width on the card (depth, or parameter dtype, cut
    as ``cut`` says): loss and last logits through the kernel path, the
    launches of each forward, each kernel on the inputs the model first
    gives it, and a float32 twin of the first ``twin_layers`` layers, card
    against CPU (None: the smoke config's twin instead); a moe's twin also
    routes every token to the same experts, kept and dropped alike."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as ssd_mod
    from repro_torch.models import forward_logits_last, forward_loss, init_params

    t_phase = time.perf_counter()
    full = get_config(arch)
    cfg = kernel_route(dataclasses.replace(full, **(cut or {})))
    calls = expected_calls(cfg)
    t0 = time.perf_counter()
    params = draw_params(cfg, seed, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    batch = model_batch(cfg, MODEL_BATCH, MODEL_SEQ, rng, dev)
    logits_shape = (MODEL_BATCH, 1) + ((cfg.num_lm_heads,) if cfg.num_lm_heads > 1
                                       else ()) + (cfg.vocab_size,)
    runs = {}
    for fn_name, fn in (("forward_loss", forward_loss),
                        ("forward_logits_last", forward_logits_last)):
        reset_all(counters, flash_mod, ssd_mod)
        t0 = time.perf_counter()
        out = fn(params, batch if fn is forward_loss else
                 {k: v for k, v in batch.items() if k != "labels"}, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # bf16 compute: every flash launch on the wgmma route, every SSD
        # call on the tensor-core route
        launches, routes = held_calls(f"{phase} {arch} {fn_name}", counters, calls,
                                      cfg.compute_dtype, flash_mod, ssd_mod)
        check(bool(torch.isfinite(out).all()), f"{phase} {arch} {fn_name}: "
              "non-finite output")
        runs[fn_name] = dict(wall_s=wall, tokens_per_s=MODEL_BATCH * MODEL_SEQ / wall,
                             launches=launches, flash_launches_by_route=routes["flash"],
                             ssd_calls_by_route=routes["ssd"])
        if fn_name == "forward_loss":
            # the value is the random init's (whose fan-in counts the stacked
            # layer axis, as the reference's does); the CPU twin below holds it
            loss = float(out)
            check(out.shape == () and loss > 0.0, f"{phase} {arch}: loss {loss}")
        else:
            check(tuple(out.shape) == logits_shape,
                  f"{phase} {arch}: logits of shape {tuple(out.shape)}")
            last_logits = out

    cases = layer0_cases(arch, params, batch, cfg, flash_mod, ssd_mod, ref)

    # CPU twin: the first layers in float32, card and CPU (a config too
    # large for the host: its smoke config, card and CPU)
    if twin_layers is None:
        twin_cfg = kernel_route(get_smoke_config(arch))
        twin = init_params(twin_cfg, seed, device=dev)
        twin_batch = model_batch(twin_cfg, TWIN_BATCH, TWIN_SMOKE_SEQ, rng, dev)
        twin_of = "smoke config"
    else:
        twin, twin_cfg = cut_depth(params, cfg, twin_layers)
        twin_batch = head_of(batch, TWIN_BATCH, TWIN_SEQ)
        twin_of = f"the first {twin_layers} layers"
    twin_cfg = dataclasses.replace(twin_cfg, compute_dtype=torch.float32)
    twin_calls = {k: 2 * n for k, n in expected_calls(twin_cfg).items()}
    reset_all(counters, flash_mod, ssd_mod)
    card_routing, cpu_routing = [], []
    with routes_recorded(card_routing):
        card = forward_logits_last(twin, twin_batch, twin_cfg)
        card_loss = forward_loss(twin, twin_batch, twin_cfg)
    torch.cuda.synchronize()
    # float32 compute: every flash and SSD call takes its tf32x3 route
    twin_launches, twin_routes = held_calls(
        f"{phase} {arch}: the float32 twin", counters, twin_calls, torch.float32,
        flash_mod, ssd_mod)
    t0 = time.perf_counter()
    twin_cpu = tensors_to(twin, "cpu")
    batch_cpu = {k: v.cpu() for k, v in twin_batch.items()}
    with routes_recorded(cpu_routing):
        cpu = forward_logits_last(twin_cpu, batch_cpu, twin_cfg)
        cpu_loss = forward_loss(twin_cpu, batch_cpu, twin_cfg)
    cpu_s = time.perf_counter() - t0
    del twin_cpu
    twin_err = float((card.cpu() - cpu).abs().max())
    check(torch.allclose(card.cpu(), cpu, atol=TWIN_TOL, rtol=TWIN_TOL)
          and torch.allclose(card_loss.cpu(), cpu_loss, atol=TWIN_TOL, rtol=TWIN_TOL),
          f"{phase} {arch}: the CPU twin differs: last logits by {twin_err}, "
          f"loss {float(card_loss)} vs {float(cpu_loss)}")
    routing = None
    if cfg.moe is not None:
        same = len(card_routing) == len(cpu_routing) and all(
            torch.equal(a, c) and torch.equal(b, d)
            for (a, b), (c, d) in zip(card_routing, cpu_routing))
        dropped = sum(int((~keep).sum()) for _, keep in card_routing)
        check(same and card_routing, f"{phase} {arch}: the twin's expert ids or keep "
              "masks differ between card and CPU")
        routing = dict(routings=len(card_routing), picks=sum(
            ids.numel() for ids, _ in card_routing), dropped_picks=dropped,
            ids_and_keep_equal=same)
    rec = dict(phase=phase, arch=arch, family=cfg.family, reduced=cuts_of(full, cfg),
               params=cfg.param_count(), active_params=cfg.active_param_count(),
               param_dtype=dtype_name(cfg.param_dtype), layers=cfg.num_layers,
               attn_layers=cfg.num_attn_layers, d_model=cfg.d_model,
               vocab=cfg.vocab_size, compute_dtype=dtype_name(cfg.compute_dtype),
               batch=MODEL_BATCH, seq=MODEL_SEQ, seed=seed, init_s=init_s,
               loss=loss, logits_last_finite=True, logits_shape=list(logits_shape),
               logits_last_abs_max=float(last_logits.float().abs().max()),
               runs=runs, launches_per_forward=runs["forward_logits_last"]["launches"],
               flash_launches_by_route=runs["forward_logits_last"][
                   "flash_launches_by_route"],
               ssd_calls_by_route=runs["forward_logits_last"]["ssd_calls_by_route"],
               layer0_kernel_cases=cases,
               cpu_twin=dict(of=twin_of, layers=twin_cfg.num_layers,
                             batch=TWIN_BATCH, positions=positions_of(batch_cpu),
                             dtype="float32", tolerance=TWIN_TOL,
                             flash_launches_by_route=twin_routes["flash"],
                             ssd_calls_by_route=twin_routes["ssd"], max_abs_err=twin_err,
                             loss_card=float(card_loss), loss_cpu=float(cpu_loss),
                             card_launches=twin_launches, routing=routing, cpu_s=cpu_s),
               phase_s=time.perf_counter() - t_phase)
    if len(cases) == 1:     # the one kernel's case, for the kernels line
        rec["layer0_kernel_case"] = next(iter(cases.values()))
    return params, cfg, rec


def decode_after_prefill(params, batch, cfg):
    """One ``decode_step`` after ``prefill`` of all but the batch's last
    position, and the kernel path's ``forward_logits_last`` of all of it:
    (decode logits, forward logits)."""
    from repro_torch.data import split_last
    from repro_torch.models import decode_step, forward_logits_last, prefill
    want = forward_logits_last(params, {k: v for k, v in batch.items() if k != "labels"},
                               cfg)
    head, tail = split_last(batch)
    _, cache = prefill(params, head, cfg, max_len=positions_of(batch) + 8)
    got, _ = decode_step(params, tail, cache, cfg)
    return got, want


def engine_run(arch, params, cfg, prompts, rng, dev, counters) -> dict:
    """StaticBatchEngine on the card: 4 requests of ``prompts`` tokens,
    SERVE_NEW new tokens each, SERVE_SLOTS slots."""
    from repro_torch.serve import Request, ServeConfig, StaticBatchEngine
    eng = StaticBatchEngine(cfg, params, ServeConfig(
        batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN), device=dev)
    for i, n in enumerate(prompts):
        eng.submit(Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                           max_new_tokens=SERVE_NEW))
    reset(counters)
    t0 = time.perf_counter()
    done = eng.run()
    wall = time.perf_counter() - t0
    launches = read(counters)
    st = eng.stats
    waves = -(-len(prompts) // SERVE_SLOTS)
    check(len(done) == len(prompts)
          and all(r.done and len(r.output) == SERVE_NEW
                  and all(0 <= t < cfg.vocab_size for t in r.output) for r in done)
          and st["waves"] == waves and st["decode_steps"] == waves * SERVE_NEW,
          f"serve {arch}: {len(done)} requests done, stats {st}")
    # prefill and decode run the plain paths: no kernel
    check(not any(launches.values()), f"serve {arch}: the engine launched {launches}")
    return dict(prompts=list(prompts), new_tokens=SERVE_NEW, slots=SERVE_SLOTS,
                waves=st["waves"], decode_steps=st["decode_steps"],
                slot_utilization=eng.slot_utilization,
                prefill_ms_per_wave=st["prefill"] / st["waves"] * 1e3,
                decode_ms_per_step=st["decode"] / st["decode_steps"] * 1e3,
                tokens_out=sum(len(r.output) for r in done), wall_s=wall,
                launches=launches)


def decode_check(arch, params, cfg, rng, dev, counters, bf16_depths=True) -> dict:
    """Decode after prefill of CHECK_SEQ - 1 positions against the kernel
    path's forward of CHECK_SEQ: held in float32 at the model's depth (every
    flash and SSD call on its tf32x3 route); in bf16 the drift recorded, and
    with ``bf16_depths`` recorded by depth and the card's bf16 prefill +
    decode held against the CPU's at the twin's depth."""
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ssd as ssd_mod
    from repro_torch.models.moe import one_group
    batch = model_batch(cfg, 1, CHECK_SEQ, rng, dev)
    cfg = one_group(cfg, CHECK_SEQ)
    calls = expected_calls(cfg)
    drift, check_s, routes = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        name = dtype_name(dtype)
        reset_all(counters, flash_mod, ssd_mod)
        t0 = time.perf_counter()
        got, want = decode_after_prefill(params, batch, c)
        torch.cuda.synchronize()
        check_s[name] = time.perf_counter() - t0
        # the forward launches its kernels; prefill and decode none
        _, routes[name] = held_calls(f"serve {arch}: the {name} check", counters, calls,
                                     dtype, flash_mod, ssd_mod)
        check(got.shape == want.shape, f"serve {arch}: decode logits {tuple(got.shape)}, "
              f"forward {tuple(want.shape)}")
        drift[name] = float((got.float() - want.float()).abs().max())
    # float32: the two paths differ only in the order of sums
    check(drift["float32"] <= DECODE_TOL,
          f"serve {arch}: decode after prefill differs from the forward by "
          f"{drift['float32']} (float32)")
    rec = dict(seq=CHECK_SEQ, tolerance=DECODE_TOL, held="float32",
               moe_group_size=cfg.moe.group_size if cfg.moe else None,
               max_abs_err=drift, seconds=check_s,
               flash_launches_by_route={k: v["flash"] for k, v in routes.items()},
               ssd_calls_by_route={k: v["ssd"] for k, v in routes.items()})
    if not bf16_depths:
        return rec
    # bf16: the plain prefill/decode path rounds attention probabilities
    # (and the SSD scan's C B^T and intra-chunk product) to bf16 in every
    # layer, as the reference's does, where the kernels keep float32; the
    # drift from the forward is recorded by depth.  What is held: the
    # card's bf16 prefill + decode against the CPU's at TWIN_LAYERS (the
    # CPU tests hold the CPU's against the JAX package's in bf16)
    c16 = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    by_depth = {}
    for L in sorted({TWIN_LAYERS, cfg.num_layers // 4, cfg.num_layers // 2}):
        p, c = cut_depth(params, c16, L)
        got, want = decode_after_prefill(p, batch, c)
        by_depth[L] = float((got.float() - want.float()).abs().max())
    by_depth[cfg.num_layers] = drift["bfloat16"]
    twin, twin_cfg = cut_depth(params, c16, TWIN_LAYERS)
    twin_batch = head_of(batch, 1, TWIN_SEQ)
    card = decode_after_prefill(twin, twin_batch, twin_cfg)
    t0 = time.perf_counter()
    cpu = decode_after_prefill(tensors_to(twin, "cpu"),
                               {k: v.cpu() for k, v in twin_batch.items()}, twin_cfg)
    cpu_s = time.perf_counter() - t0
    twin_errs = [float((g.float().cpu() - w.float()).abs().max())
                 for g, w in zip(card, cpu)]
    check(all(torch.allclose(g.float().cpu(), w.float(), atol=TWIN_TOL_BF16,
                             rtol=TWIN_TOL_BF16) for g, w in zip(card, cpu)),
          f"serve {arch}: bf16 decode and forward logits on the card differ "
          f"from the CPU's by {twin_errs}")
    rec.update(bf16_max_abs_err_by_layers=by_depth,
               bf16_cpu_twin=dict(layers=TWIN_LAYERS, seq=TWIN_SEQ,
                                  tolerance=TWIN_TOL_BF16,
                                  decode_max_abs_err=twin_errs[0],
                                  forward_max_abs_err=twin_errs[1], cpu_s=cpu_s))
    return rec


def serve_phase(arch, params, cfg, seed, dev, counters, prompts=SERVE_PROMPTS,
                bf16_depths=True):
    """StaticBatchEngine on the card, then decode after prefill against the
    kernel path's forward (:func:`decode_check`)."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed)
    rec = dict(phase="serve", arch=arch, **engine_run(arch, params, cfg, prompts, rng,
                                                      dev, counters))
    rec["decode_after_prefill"] = decode_check(arch, params, cfg, rng, dev, counters,
                                               bf16_depths)
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


def frames_decode(arch, params, cfg, rng, dev, counters) -> dict:
    """An audio model served on frames: prefill of FRAMES_PROMPT frames for
    MODEL_BATCH sequences, then SERVE_NEW decode steps, each on a new frame
    (the frontend stub's input: a codebook-summed embedding); logits (B, 1,
    heads, V) finite, ms a step."""
    from repro_torch.models import decode_step, prefill
    batch = model_batch(cfg, MODEL_BATCH, FRAMES_PROMPT + SERVE_NEW, rng, dev)
    frames = batch["frames"]
    reset(counters)
    t0 = time.perf_counter()
    _, cache = prefill(params, {"frames": frames[:, :FRAMES_PROMPT]}, cfg,
                       max_len=FRAMES_PROMPT + SERVE_NEW)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(FRAMES_PROMPT, FRAMES_PROMPT + SERVE_NEW):
        logits, cache = decode_step(params, {"frames": frames[:, i:i + 1]}, cache, cfg)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = read(counters)
    want = (MODEL_BATCH, 1, cfg.num_lm_heads, cfg.vocab_size)
    check(tuple(logits.shape) == want and bool(torch.isfinite(logits).all())
          and int(cache["attn"]["length"][0]) == FRAMES_PROMPT + SERVE_NEW
          and not any(launches.values()),
          f"frames_decode {arch}: logits {tuple(logits.shape)}, launches {launches}")
    return dict(batch=MODEL_BATCH, prompt_frames=FRAMES_PROMPT, decode_steps=SERVE_NEW,
                prefill_ms=prefill_s * 1e3, decode_ms_per_step=decode_s / SERVE_NEW * 1e3,
                logits_shape=list(want), launches=launches)


def serve_decode_example(arch, dev, counters) -> dict:
    """The ported serving demo (``repro_torch.examples.serve_decode``) at
    the published widths on the card: its prefill (an image's patches
    before the prompt) and greedy decode; every token in the vocabulary."""
    import contextlib
    import io
    from repro_torch.examples import serve_decode
    argv = ["--arch", arch, "--full", "--batch", str(EXAMPLE_BATCH),
            "--prompt-len", str(EXAMPLE_PROMPT), "--new-tokens", str(SERVE_NEW),
            "--device", str(dev)]
    reset(counters)
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        out = serve_decode.main(argv)
    launches = read(counters)
    tokens, cfg = out["tokens"], out["cfg"]
    check(tokens.shape == (EXAMPLE_BATCH, SERVE_NEW)
          and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
          and not any(launches.values()),
          f"serve_decode {arch}: tokens {tokens.shape}, launches {launches}")
    rec = dict(argv=argv, positions=cfg.num_frontend_tokens + EXAMPLE_PROMPT,
               prefill_s=out["prefill_s"], decode_ms_per_step=out["decode_s"] / SERVE_NEW * 1e3,
               tokens_per_s=EXAMPLE_BATCH * SERVE_NEW / out["decode_s"],
               printed=printed.getvalue().splitlines(), launches=launches)
    del out
    return rec


def model_families_phase(dev, counters) -> tuple[dict, dict]:
    """The hybrid, vlm, audio and moe families at full width (two moe
    configs cut in depth, arctic also to bf16 parameters): each through
    :func:`model_forward_phase` (one line each), then zamba2 and qwen3-moe
    through the serving engine, decode after prefill held for four of them,
    musicgen decoding on frames, paligemma through the serving demo."""
    t_phase = time.perf_counter()
    models = {}
    for arch, cut, twin in FAMILY_ARCHS:
        params, cfg, rec = model_forward_phase(arch, 0, dev, counters, cut=cut,
                                               twin_layers=twin, phase="model_families")
        rng = np.random.default_rng(1)
        if arch in FAMILY_SERVE:
            rec["serve"] = engine_run(arch, params, cfg, FAMILY_SERVE[arch], rng, dev,
                                      counters)
        if arch in FAMILY_CHECK:
            rec["decode_after_prefill"] = decode_check(arch, params, cfg, rng, dev,
                                                       counters, bf16_depths=False)
        if cfg.frontend == "frames":
            rec["frames_decode"] = frames_decode(arch, params, cfg, rng, dev, counters)
        del params
        torch.cuda.empty_cache()
        if cfg.frontend == "patches":
            rec["serve_decode_example"] = serve_decode_example(arch, dev, counters)
            torch.cuda.empty_cache()
        rec["forward_s"] = rec["phase_s"]
        rec["phase_s"] = time.perf_counter() - t_phase - sum(
            m["phase_s"] for m in models.values())
        emit(rec)
        models[arch] = rec
    return dict(phase="model_families", archs=list(models),
                launches_per_forward={a: m["launches_per_forward"] for a, m in models.items()},
                reduced={a: m["reduced"] for a, m in models.items()},
                tokens_per_s={a: m["runs"]["forward_logits_last"]["tokens_per_s"]
                              for a, m in models.items()},
                phase_s=time.perf_counter() - t_phase), models


# ---- the paper-figure drivers and the trial executor's pieces -------------------

def card_name_and_power() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def figure_rows(fn, *argv) -> tuple[list[dict], float]:
    """Runs a figure driver with ``argv`` as its command line, capturing its
    ``name,us_per_call,derived`` rows; (rows, seconds)."""
    import contextlib
    import io
    buf, saved = io.StringIO(), sys.argv
    sys.argv = ["chip_smoke.py", *argv]
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            fn()
    finally:
        sys.argv = saved
    seconds = time.perf_counter() - t0
    rows = []
    for line in buf.getvalue().splitlines():
        name, us, derived = line.split(",", 2)
        rows.append(dict(name=name, us_per_call=float(us),
                         derived=dict(kv.split("=", 1) for kv in derived.split(";"))))
    return rows, seconds


def captured(mod, calls: list):
    """Wraps ``mod.simulate_batch`` to append each call's (problem, batch)
    to ``calls``; returns the original."""
    orig = mod.simulate_batch

    def run(problem, specs, *a, **kw):
        batch = orig(problem, specs, *a, **kw)
        calls.append((problem, batch))
        return batch
    mod.simulate_batch = run
    return orig


def trial_logs(batch, i) -> list:
    return list(zip(batch.trial_model[i].tolist(), batch.trial_user[i].tolist(),
                    batch.trial_device[i].tolist()))


def held_to_event(name, batch, i, res) -> dict:
    """Batched episode i against an event-engine episode: models, hints and
    devices equal, start and end times within BATCHED_TIME_TOL."""
    check(trial_logs(batch, i) == [(t.model, t.user_hint, t.device) for t in res.trials],
          f"{name}: the batched episode's trials differ from the event engine's")
    err = 0.0
    for key, attr in (("trial_start", "start"), ("trial_end", "end")):
        want = np.asarray([getattr(t, attr) for t in res.trials])
        got = getattr(batch, key)[i].astype(np.float64)
        check(bool(np.all(np.abs(got - want) <= BATCHED_TIME_TOL * (1 + np.abs(want)))),
              f"{name}: {key} differs from the event engine's beyond {BATCHED_TIME_TOL}")
        err = max(err, float(np.abs(got - want).max()))
    return dict(trials=len(res.trials), max_abs_time_err=err,
                decisions=int(batch.decisions[i]), event_decisions=res.decisions)


def random_invariants(name, batch, i) -> None:
    """A random-baseline episode: each model launched and observed once, the
    warm start first, each policy pick a model of its hint's tenant, a
    tenant that still had work."""
    prob = batch.problem
    N = prob.num_users
    m = prob.num_models // N
    models, hints = batch.trial_model[i], batch.trial_user[i]
    observed = batch.obs_model[i][batch.obs_model[i] >= 0]
    check(sorted(models.tolist()) == list(range(prob.num_models))
          and sorted(observed.tolist()) == list(range(prob.num_models)),
          f"{name}: a model was not launched and observed exactly once")
    left = np.ones((N, m), bool)
    for x, u in zip(models.tolist(), hints.tolist()):
        check(u == -2 or (u >= 0 and left[u].any() and x // m == u),
              f"{name}: pick {x} under hint {u} breaks the invariants")
        left[x // m, x % m] = False


def batched_phase(dev, counters):
    """The batched sweep engine on the card, (a)-(f) of BATCHED_*: the step
    loop under torch.cuda.set_sync_debug_mode("error") (read inside it), no
    launch of kernels 1-4 in (a) and (d), every deterministic episode equal
    to the event engine's, the card's batch equal to the CPU's bit for bit."""
    import io

    from repro_torch.benchmarks import fig2_single_device as f2
    from repro_torch.benchmarks import fig4_four_devices as f4
    from repro_torch.benchmarks import fig5_synthetic_speedup as f5
    from repro_torch.core import (EpisodeSpec, simulate, simulate_batch,
                                  synthetic_matern_problem, synthetic_matern_z)
    from repro_torch.core import sim_batched
    from repro_torch.examples import quickstart
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models.spec import init_from_specs

    t_phase = time.perf_counter()
    modes, routes = [], []
    loop = sim_batched._step_loop

    def watched_loop(c, s, T, *rest):
        modes.append(torch.cuda.get_sync_debug_mode() if s["P"].is_cuda else None)
        logs, route = loop(c, s, T, *rest)
        routes.append((s["P"].is_cuda, T, route))
        return logs, route
    sim_batched._step_loop = watched_loop
    out = {}
    try:
        # warm-up on a small problem: CUDA's first launches stay out of (a)
        small = synthetic_matern_problem(3, 8, seed=5)
        warm = simulate_batch(small, [EpisodeSpec("mdmt", 2, 0)], device=dev)
        out["warmup_s"] = warm.wall_seconds

        # (a) the full Fig-5 grid, one call
        calls = []
        orig = captured(f5, calls)
        saved_devices = f5.DEVICES
        f5.DEVICES = BATCHED_DEVICES
        reset(counters)
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                f5.run_batched(BATCHED_SEEDS, device=dev)
        finally:
            f5.DEVICES, f5.simulate_batch = saved_devices, orig
        launches_a = read(counters)
        check(not any(launches_a.values()),
              f"batched (a): kernels launched in the grid's call: {launches_a}")
        prob, grid = calls[0]
        B = grid.num_episodes
        check(B == len(BATCHED_DEVICES) * BATCHED_SEEDS
              and grid.obs_model.shape[1] == prob.num_models + max(BATCHED_DEVICES),
              f"batched (a): {B} episodes, {grid.obs_model.shape[1]} steps")
        rows = [dict(name=n, us_per_call=float(us), derived=dict(
            kv.split("=", 1) for kv in d.split(";")))
            for n, us, d in (ln.split(",", 2) for ln in buf.getvalue().splitlines())]
        for r in rows[:-1]:
            check(np.isfinite(float(r["derived"]["t_reach_0p01"])),
                  f"batched (a): {r['name']} did not reach regret 0.01")
        for i in range(B):
            check(sorted(grid.trial_model[i].tolist()) == list(range(prob.num_models)),
                  f"batched (a): episode {i} did not launch every model once")
        out["a"] = dict(problem="synthetic_matern_problem(50, 50, seed=0), z per seed "
                        "from synthetic_matern_z", devices=list(BATCHED_DEVICES),
                        seeds=BATCHED_SEEDS, episodes=B, steps=int(grid.obs_model.shape[1]),
                        rows=rows, wall_s=grid.wall_seconds,
                        us_per_episode=grid.wall_seconds / B * 1e6,
                        launches_kernels_1_4=launches_a)

        # (b) grid episodes against the event engine; the same batch on the CPU
        idx = [BATCHED_DEVICES.index(M) * BATCHED_SEEDS + seed for M, seed in BATCHED_EVENT]
        specs = [grid.specs[i] for i in idx]
        event = []
        t0 = time.perf_counter()
        for (M, seed), i in zip(BATCHED_EVENT, idx):
            zprob = dataclasses.replace(prob, z_true=np.asarray(grid.specs[i].z_true,
                                                                prob.z_true.dtype))
            res = simulate(zprob, "mdmt", num_devices=M, seed=seed, device=dev)
            event.append(dict(M=M, seed=seed, **held_to_event(
                f"batched (b) M {M} seed {seed}", grid, i, res)))
        event_s = time.perf_counter() - t0
        # the five as a batch on the CPU against their rows of the card's
        # grid (the same Mmax and T; an episode's steps do not depend on the
        # other episodes of its batch, as (d) shows on the card)
        cpu5 = simulate_batch(prob, specs, device="cpu")
        for key in ("trial_model", "trial_user", "trial_device", "trial_start",
                    "trial_end", "obs_model", "obs_time", "inst_regret",
                    "cum_regret", "decisions", "end_time"):
            check(np.array_equal(getattr(cpu5, key), getattr(grid, key)[idx]),
                  f"batched (b): {key} of the CPU's batch differs from the card's")
        out["b"] = dict(episodes=event, event_wall_s=event_s,
                        cpu_wall_s=cpu5.wall_seconds, card_equals_cpu_bitwise=True)

        # (c) Fig. 2 and 4 --engine batched, against the event engine
        figs = {}
        for fig, main_fn in (("fig2", f2.main), ("fig4", f4.main)):
            calls = []
            orig = captured(f2, calls)
            try:
                rows, seconds = figure_rows(lambda: main_fn(device=dev), "--engine",
                                            "batched", "--seeds", str(BATCHED_FIG_SEEDS))
            finally:
                f2.simulate_batch = orig
            t0 = time.perf_counter()
            held_n, max_err, random_n = 0, 0.0, 0
            for problem, batch in calls:
                # the random episodes (the reference's threefry stream) as a
                # batch on the CPU: equal to the card's, bit for bit
                rand = [i for i, spec in enumerate(batch.specs) if spec.policy == "random"]
                if rand:
                    cpu = simulate_batch(problem, [batch.specs[i] for i in rand],
                                         warm_start=batch.warm_start, device="cpu")
                    for key in ("trial_model", "trial_user", "trial_device",
                                "trial_start", "trial_end"):
                        check(np.array_equal(getattr(cpu, key), getattr(batch, key)[rand]),
                              f"batched (c) {fig} {problem.name}: random {key} of the "
                              "CPU differs from the card's")
                    random_n += len(rand)
                for i, spec in enumerate(batch.specs):
                    name = f"batched (c) {fig} {problem.name} {spec.policy}"
                    if spec.policy == "random":
                        random_invariants(name, batch, i)
                        continue
                    res = simulate(problem, spec.policy, num_devices=spec.num_devices,
                                   seed=spec.seed, device=dev)
                    max_err = max(max_err, held_to_event(name, batch, i, res)
                                  ["max_abs_time_err"])
                    held_n += 1
            figs[fig] = dict(rows=rows, seconds=seconds, calls=len(calls),
                             batched_wall_s=sum(b.wall_seconds for _, b in calls),
                             episodes_held_to_event=held_n, max_abs_time_err=max_err,
                             random_episodes_card_equals_cpu=random_n,
                             event_check_s=time.perf_counter() - t0)
        out["c"] = figs

        # (d) DESIGN.md §6's scale: B 1,024 in one call
        Ms, seeds = BATCHED_SWEEP
        zs = [synthetic_matern_z(50, 50, seed=s) for s in range(seeds)]
        sweep_specs = [EpisodeSpec("mdmt", M, s, z_true=zs[s]) for M in Ms for s in range(seeds)]
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        reset(counters)
        sweep = simulate_batch(prob, sweep_specs, device=dev)
        launches_d = read(counters)
        check(not any(launches_d.values()),
              f"batched (d): kernels launched in the sweep: {launches_d}")
        peak = torch.cuda.max_memory_allocated()
        # the episodes (a) also ran, at other batch positions: equal logs
        same = [(Ms.index(M) * seeds + s, BATCHED_DEVICES.index(M) * BATCHED_SEEDS + s)
                for M in BATCHED_DEVICES for s in range(BATCHED_SEEDS)]
        for key in ("trial_model", "trial_user", "trial_device", "trial_end",
                    "inst_regret", "cum_regret"):
            check(all(np.array_equal(getattr(sweep, key)[i], getattr(grid, key)[j])
                      for i, j in same),
                  f"batched (d): {key} of (a)'s episodes differs inside the sweep")
        tt = sweep.time_to_instantaneous(0.01).reshape(len(Ms), seeds)
        check(bool(np.isfinite(tt).all()), "batched (d): an episode never reached 0.01")
        out["d"] = dict(devices=list(Ms), seeds=seeds, episodes=sweep.num_episodes,
                        wall_s=sweep.wall_seconds,
                        us_per_episode=sweep.wall_seconds / sweep.num_episodes * 1e6,
                        max_memory_allocated=peak, memory_before=base_mem,
                        launches_kernels_1_4=launches_d, equals_a_episodes=len(same),
                        t_reach_0p01_mean_by_M={str(M): float(tt[k].mean())
                                                for k, M in enumerate(Ms)})
        del sweep
        torch.cuda.empty_cache()
    finally:
        sim_batched._step_loop = loop
    check(all(mode == 2 for mode in modes if mode is not None)
          and sum(mode is not None for mode in modes) >= 4,
          f"batched: the step loop ran under sync debug modes {modes}")
    out["step_loop_sync_debug_modes"] = sorted({m for m in modes if m is not None})
    # on the card every call replays steps 1 to T - 1 from its CUDA graph
    check(all(r == ({"graph_steps": T - 1, "eager_steps": 1} if cuda
                    else {"graph_steps": 0, "eager_steps": T}) for cuda, T, r in routes),
          f"batched: step routes {[r for _, _, r in routes]}")
    out["step_loop_graphed_calls"] = sum(cuda for cuda, _, _ in routes)

    # (e) the quickstart's entry point on the card and on the CPU
    lines = {}
    reset(counters)
    for where in (dev, "cpu"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            quickstart.main(device=where)
        lines[str(where)] = (buf.getvalue().splitlines(), time.perf_counter() - t0)
        if where == dev:
            launches_e = read(counters)
    check(lines[str(dev)][0] == lines["cpu"][0],
          f"batched (e): the quickstart's lines differ, card {lines[str(dev)][0]} "
          f"CPU {lines['cpu'][0]}")
    check(launches_e["eirate"] > 0 and launches_e["gp_readout"] > 0,
          f"batched (e): the quickstart on the card launched {launches_e}")
    out["e"] = dict(lines=lines[str(dev)][0], card_s=lines[str(dev)][1],
                    cpu_s=lines["cpu"][1], launches=launches_e, card_equals_cpu=True)

    # (f) one write_back=False decode step at qwen3-4b layer 0's attention
    # shape: float32 held to DATA_TOL against write_back=True and the CPU
    acfg = get_config("qwen3-4b").attn_cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    p = init_from_specs(attn.attn_specs(acfg), gen, device=dev)
    cpu_p = tensors_to(p, "cpu")
    B, size = 4, BATCHED_DECODE_CACHE
    shape = (B, size, acfg.num_kv_heads, acfg.head_dim)
    k = torch.randn(shape, generator=gen, device=dev).bfloat16()
    v = torch.randn(shape, generator=gen, device=dev).bfloat16()
    x = torch.randn((B, 1, acfg.d_model), generator=gen, device=dev).bfloat16()

    def step(params, dtype, where, length, write_back):
        cache = attn.KVCache(k.to(where, dtype), v.to(where, dtype),
                             torch.tensor(length, dtype=torch.int32, device=where))
        return attn.attention_decode(params, x.to(where, dtype), cache, acfg,
                                     write_back=write_back)

    cases = {}
    for length in (size // 2 + 1, size + 5):        # before and after the ring wraps
        y32, c32 = step(p, torch.float32, dev, length, False)
        wb32, cwb32 = step(p, torch.float32, dev, length, True)
        slot = length % size
        check(c32.k.shape == (B, 1, acfg.num_kv_heads, acfg.head_dim)
              and torch.equal(cwb32.k[:, slot:slot + 1], c32.k)
              and torch.equal(cwb32.v[:, slot:slot + 1], c32.v),
              f"batched (f): length {length}, the returned new-token k, v")
        case = dict(float32=dict(
            vs_write_back=held(f"batched (f) {length} float32 vs write_back", y32, wb32),
            card_vs_cpu=held(f"batched (f) {length} float32 card vs CPU", y32.cpu(),
                             step(cpu_p, torch.float32, "cpu", length, False)[0])))
        # bf16: the branches round different intermediates (the cache-in-carry
        # branch rounds its two partial mixes and their sum), so they part by
        # a bf16 ulp of the attention output, spread by the projection, which
        # bf16 DATA_TOL (one rounding of one float32 result) does not cover:
        # each branch is held to its own float32 step on the same bf16
        # values, the new branch's error at most BF16_BRANCH_RATIO times the
        # write-back branch's; the differences are printed
        yb, _ = step(p, torch.bfloat16, dev, length, False)
        wbb, _ = step(p, torch.bfloat16, dev, length, True)
        ybc, _ = step(cpu_p, torch.bfloat16, "cpu", length, False)
        err_f = float((yb.float() - y32).abs().max())
        err_t = float((wbb.float() - wb32).abs().max())
        check(bool(torch.isfinite(yb).all()) and err_f <= BF16_BRANCH_RATIO * err_t,
              f"batched (f): length {length}, bf16 write_back=False errs by {err_f} "
              f"against its float32 step, write_back=True by {err_t}")
        case["bfloat16"] = dict(
            err_vs_float32=err_f, write_back_err_vs_float32=err_t,
            max_abs_y=float(wb32.abs().max()),
            vs_write_back_max_abs_err=float((yb.float() - wbb.float()).abs().max()),
            card_vs_cpu_max_abs_err=float((yb.float().cpu() - ybc.float()).abs().max()),
            cpu_err_vs_float32=float((ybc.float() - y32.cpu()).abs().max()),
            ms=cuda_ms(lambda: step(p, torch.bfloat16, dev, length, False), 20),
            write_back_ms=cuda_ms(lambda: step(p, torch.bfloat16, dev, length, True), 20))
        cases[str(length)] = case
    out["f"] = dict(shape=dict(B=B, cache=size, Hq=acfg.num_heads, Hkv=acfg.num_kv_heads,
                               D=acfg.head_dim, d_model=acfg.d_model),
                    cases=cases)
    return dict(phase="batched", card=card_name_and_power(), **out,
                phase_s=time.perf_counter() - t_phase)


def figures_phase(dev, counters):
    """The port's Fig. 2-5 drivers on the card (FIG_SEEDS, FIG5_DEVICES),
    with the kernel launches of exactly those runs; then Fig. 2-4 at one
    seed on the card and on the CPU (plain versions): equal derived fields."""
    from repro_torch.benchmarks import common as bench
    from repro_torch.benchmarks import fig2_single_device as f2
    from repro_torch.benchmarks import fig3_multi_device as f3
    from repro_torch.benchmarks import fig4_four_devices as f4
    from repro_torch.benchmarks import fig5_synthetic_speedup as f5

    # every episode's policy, decisions and policy trials (user_hint -1:
    # an mdmt pick; each launches the EIrate kernel once)
    episodes = []

    def counted(res_fn):
        def run(problem, policy, num_devices, seed, device=None):
            res = res_fn(problem, policy, num_devices, seed, device)
            episodes.append((policy, res.decisions,
                             sum(t.user_hint == -1 for t in res.trials)))
            return res
        return run

    for mod in (f2, f3, f5):
        mod.episode = counted(bench.episode)
    f5.DEVICES = FIG5_DEVICES
    mains = {"fig2": f2.main, "fig3": f3.main, "fig4": f4.main, "fig5": f5.main}
    t_phase = time.perf_counter()
    reset(counters)
    figs = {}
    for fig, main_fn in mains.items():
        rows, seconds = figure_rows(lambda: main_fn(device=dev),
                                    "--seeds", str(FIG_SEEDS[fig]))
        figs[fig] = dict(seeds=FIG_SEEDS[fig], seconds=seconds, rows=rows)
    torch.cuda.synchronize()
    launches = read(counters)
    wall = time.perf_counter() - t_phase
    n_episodes = len(episodes)
    mdmt = [e for e in episodes if e[0] == "mdmt"]
    mdmt_decisions = sum(e[1] for e in mdmt)
    mdmt_picks = sum(e[2] for e in mdmt)
    check(launches["eirate"] == mdmt_picks and launches["gp_readout"] > 0
          and launches["eirate_topk"] == launches["eirate_classes"] == 0,
          f"figures: launches {launches}, expected {mdmt_picks} EIrate launches "
          "(one per mdmt pick), some readouts and no other kernel")
    for fig, rec in figs.items():
        for row in rec["rows"]:
            reached = {k: v for k, v in row["derived"].items() if k.startswith("t_reach_")}
            check(bool(reached) and all(np.isfinite(float(v)) for v in reached.values()),
                  f"figures: {row['name']} did not reach a threshold: {reached}")
    # Fig. 2-4 at one seed, card against CPU
    twin = {}
    for fig in ("fig2", "fig3", "fig4"):
        card, _ = figure_rows(lambda: mains[fig](device=dev), "--seeds", str(FIG_TWIN_SEEDS))
        cpu, cpu_s = figure_rows(lambda: mains[fig](device="cpu"),
                                 "--seeds", str(FIG_TWIN_SEEDS))
        strip = lambda rows: [(r["name"], r["derived"]) for r in rows]
        check(strip(card) == strip(cpu),
              f"figures: {fig} at {FIG_TWIN_SEEDS} seed(s), the card's rows "
              f"{strip(card)} differ from the CPU's {strip(cpu)}")
        twin[fig] = dict(rows=len(cpu), cpu_s=cpu_s)
    merit = {r["name"]: {k: r["derived"][k] for k in ("speedup_vs_M1", "linearity")
                         if k in r["derived"]}
             for fig in ("fig3", "fig5") for r in figs[fig]["rows"]}
    return dict(phase="figures", card=card_name_and_power(),
                protocol=dict(seeds=FIG_SEEDS, fig5_devices=list(f5.DEVICES),
                              fig5_problem="synthetic_matern_problem(50, 50, seed=repeat)",
                              fig5_protocol=FIG5_PROTOCOL),
                figures=figs, launches=launches, episodes=n_episodes,
                mdmt_episodes=len(mdmt), mdmt_decisions=mdmt_decisions,
                mdmt_picks=mdmt_picks, wall_s=wall,
                speedup_and_linearity=merit,
                cpu_twin=dict(seeds=FIG_TWIN_SEEDS, derived_equal_card=True, **twin))


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |x| (float32 in, the binade's spacing out)."""
    a = x.abs().clamp(min=torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def held_leaf(name, got, want) -> float:
    """A leaf of the card's AdamW step against the CPU twin's: float32 to
    TRAIN_TOL_F32 of each value, bf16 to one bf16 ulp; the largest error."""
    g, w = got.cpu().float(), want.float()
    diff = (g - w).abs()
    lim = bf16_ulp(w) if want.dtype == torch.bfloat16 else TRAIN_TOL_F32 * w.abs()
    check(got.dtype == want.dtype and got.shape == want.shape
          and bool(torch.isfinite(g).all()) and bool((diff <= lim).all()),
          f"train_pieces: {name} differs from the CPU twin by {float(diff.max())}")
    return float(diff.max())


def train_pieces_phase(dev):
    """One AdamW step and one int8 compression of the gradients on
    TRAIN_ARCH's full parameter tree on the card, each held against a CPU
    twin, the step timed beside its bytes bound; then the cost model's
    analytic step times on one card."""
    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.core import cost_model as cm
    from repro_torch.models import model_specs
    from repro_torch.models.spec import tree_leaves, tree_map
    from repro_torch.train import compress, optimizer as opt

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    gen = torch.Generator(device=dev).manual_seed(0)

    def draw(spec, std, dtype, square=False):
        t = torch.empty(spec.shape, dtype=torch.float32, device=dev)
        t.normal_(0.0, std, generator=gen)
        return (t.square_() if square else t).to(dtype)

    specs = model_specs(cfg)
    params = tree_map(lambda s: draw(s, 0.02, torch.bfloat16), specs)
    grads = tree_map(lambda s: draw(s, TRAIN_GRAD_STD, torch.bfloat16), specs)
    ocfg = opt.OptConfig(moment_dtype=torch.float32)
    state = {"mu": tree_map(lambda s: draw(s, 1e-4, torch.float32), specs),
             "nu": tree_map(lambda s: draw(s, 1e-3, torch.float32, square=True), specs),
             "step": torch.tensor(TRAIN_STEP, dtype=torch.int32, device=dev)}
    n = cfg.param_count()
    check(sum(t.numel() for t in tree_leaves(params)) == n,
          "train_pieces: the tree's leaves do not add up to param_count")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    new_params, new_state, metrics = opt.adamw_update(params, grads, state, ocfg)
    torch.cuda.synchronize()
    gnorm, lr = metrics["grad_norm"], metrics["lr"]
    check(bool(torch.isfinite(gnorm)) and float(gnorm) > ocfg.clip_norm,
          f"train_pieces: grad norm {float(gnorm)} (the step should clip)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the CPU twin of the first layers, with the card's global norm
    first = lambda tree: tree_map(lambda a: a[:TRAIN_TWIN_LAYERS].cpu(), tree["blocks"])
    t0 = time.perf_counter()
    cpu_p, cpu_state, cpu_met = opt._update(
        first(params), first(grads),
        {"mu": first(state["mu"]), "nu": first(state["nu"]), "step": state["step"].cpu()},
        ocfg, gnorm.cpu())
    adamw_cpu_s = time.perf_counter() - t0
    errs = {}
    for what, got, want in (("params", new_params, cpu_p),
                            ("mu", new_state["mu"], cpu_state["mu"]),
                            ("nu", new_state["nu"], cpu_state["nu"])):
        g_leaves = tree_leaves(first(got))
        errs[what] = max(held_leaf(f"{what} leaf {i}", g, w) for i, (g, w) in
                         enumerate(zip(g_leaves, tree_leaves(want))))
    check(int(new_state["step"]) == int(cpu_state["step"]) == TRAIN_STEP + 1
          and abs(float(lr) - float(cpu_met["lr"])) <= TRAIN_TOL_F32 * abs(float(lr)),
          f"train_pieces: step or lr differs from the CPU's: {float(lr)} vs "
          f"{float(cpu_met['lr'])}")
    del new_params, new_state
    torch.cuda.empty_cache()
    step_ms = cuda_ms(lambda: opt.adamw_update(params, grads, state, ocfg), 3)

    # compression of the same gradients: codes and scales equal to the CPU's
    errs0 = compress.init_error_state(grads)
    codes, scales = compress.compress_tree(grads, errs0)[:2]
    torch.cuda.synchronize()
    compress_ms = cuda_ms(lambda: compress.compress_tree(grads, errs0), 3)
    t0 = time.perf_counter()
    for i, (g, q, sc) in enumerate(zip(tree_leaves(grads), tree_leaves(codes),
                                       tree_leaves(scales))):
        g_cpu = g.cpu()
        cq, cs, _ = compress.quantize_ef(g_cpu, torch.zeros(g_cpu.shape))
        check(q.dtype == torch.int8 and torch.equal(q.cpu(), cq)
              and float(sc) == float(cs),
              f"train_pieces: leaf {i}'s codes or scale differ from the CPU's")
    compress_cpu_s = time.perf_counter() - t0
    wire = compress.wire_bytes_saved(grads)
    n_leaves = len(tree_leaves(grads))
    del codes, scales, errs0

    # bytes the step must move: read params, grads and both moments, write
    # params and both moments (global_norm's second read of the grads and
    # every temporary are the implementation's)
    p_bytes, g_bytes, m_bytes = 2, 2, 4
    step_bytes = n * (2 * p_bytes + g_bytes + 4 * m_bytes)
    step_bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    # compression: read the grads and the error state, write codes and the
    # new error state
    compress_bytes = n * (g_bytes + 4 + 1 + 4)
    model = cm.CostModel()
    cost = {}
    for arch in COST_ARCHS:
        acfg = get_config(arch)
        cost[arch] = {shape: dict(step_seconds=model.step_seconds(arch, shape, chips=1),
                                  probe=model._probe(arch, shape) is not None)
                      for shape in SHAPES if shape_applicable(acfg, shape)}
    del params, grads, state
    torch.cuda.empty_cache()
    return dict(phase="train_pieces", card=card_name_and_power(), arch=TRAIN_ARCH,
                params=n, param_dtype="bfloat16", grad_dtype="bfloat16",
                moment_dtype="float32", state_step=TRAIN_STEP,
                grad_norm=float(gnorm), lr=float(lr), clip_norm=ocfg.clip_norm,
                peak_memory_gb=peak_gb,
                adamw_step=dict(ms=step_ms, bytes=step_bytes, bound_ms=step_bound_ms,
                                bound_by="bytes", ms_over_bound=step_ms / step_bound_ms),
                cpu_twin=dict(layers=TRAIN_TWIN_LAYERS, tolerance=dict(
                    float32_rtol=TRAIN_TOL_F32, bfloat16="one bf16 ulp"),
                    max_abs_err=errs, adamw_cpu_s=adamw_cpu_s),
                compress=dict(ms=compress_ms, bytes=compress_bytes,
                              bound_ms=compress_bytes / HBM_BYTES_PER_S * 1e3,
                              codes_equal_cpu=True, leaves=n_leaves, cpu_s=compress_cpu_s,
                              wire_bytes_float32_int8=list(wire)),
                cost_model=dict(chips=1, peak_flops=cm.PEAK_FLOPS, hbm_bw=cm.HBM_BW,
                                ici_bw=cm.ICI_BW, hbm_per_chip=cm.HBM_PER_CHIP,
                                mfu_assumption=model.mfu_assumption,
                                step_seconds=cost),
                phase_s=time.perf_counter() - t_phase)


def loss_and_grads(params, batch, cfg):
    """forward_loss and its gradient leaves (sorted key order) at ``params``."""
    from repro_torch.models import forward_loss
    from repro_torch.models.spec import tree_leaves, tree_map
    is_t = lambda x: isinstance(x, torch.Tensor)
    p = tree_map(lambda t: t.detach().requires_grad_(), params, is_t)
    leaves = tree_leaves(p, is_t)
    loss = forward_loss(p, batch, cfg)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def leaf_errs(got, want) -> list[float]:
    """Each leaf's max |got - want| over max |want| (want on the CPU)."""
    return [float((g.cpu() - w).abs().max() / w.abs().max().clamp_min(1e-30))
            for g, w in zip(got, want)]


def plain_route_ms(cfg, dev) -> dict:
    """One layer's plain attention (or SSD scan) alone at the step's shapes,
    bf16: forward, and forward + backward, CUDA-event ms; beside it the
    flash (or SSD) kernel's forward on the same inputs.  A step of remat
    "full" runs each layer's forward twice and its backward once."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import chunked_attention
    from repro_torch.models.ssm import chunked_scan

    gen = torch.Generator(device=dev).manual_seed(1)
    randn = lambda *shape, dtype=torch.bfloat16: torch.randn(
        shape, generator=gen, device=dev).to(dtype).requires_grad_()
    B, S = TRAIN_BATCH, TRAIN_SEQ
    if cfg.family == "ssm":
        H, P, N, Q = cfg.ssm.num_heads, cfg.ssm.headdim, cfg.ssm.d_state, cfg.ssm.chunk
        x, b, c = randn(B, S, H, P), randn(B, S, N), randn(B, S, N)
        dt = (torch.rand((B, S, H), generator=gen, device=dev)
              * (cfg.ssm.dt_max - cfg.ssm.dt_min) + cfg.ssm.dt_min)
        la = (-np.e * dt).requires_grad_()
        fwd = lambda: chunked_scan(x, dt, la, b, c, Q)[0]
        kernel = lambda: ops.ssd_mix(x, dt, la, b, c, chunk=Q)
    else:
        a = cfg.attn_cfg
        q, k, v = (randn(B, S, a.num_heads, a.head_dim),
                   randn(B, S, a.num_kv_heads, a.head_dim),
                   randn(B, S, a.num_kv_heads, a.head_dim))
        pos = torch.arange(S, dtype=torch.int32, device=dev)
        fwd = lambda: chunked_attention(q, k, v, a, pos)
        kernel = lambda: ops.flash_attention(q, k, v, window=a.sliding_window)
    grad = torch.ones_like(fwd())
    with torch.no_grad():
        fwd_ms = cuda_ms(fwd, 3)
        kernel_ms = cuda_ms(kernel, 3)
    fwd_bwd_ms = cuda_ms(lambda: fwd().backward(grad), 3)
    return dict(what="ssd chunked_scan" if cfg.family == "ssm" else "chunked_attention",
                fwd_ms=fwd_ms, fwd_bwd_ms=fwd_bwd_ms,
                per_step_ms=cfg.num_layers * (fwd_ms + fwd_bwd_ms),
                kernel_forward_ms=kernel_ms)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_dryrun_cells():
    """(d) of launch: each cell in its own process (the fake group is
    process-global), all at once, on the host's cores while (a)-(c) run."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    for arch, shape, rules in LAUNCH_DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--rules", rules, "--probe"]
        procs.append(subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


def _dryrun_cells(procs):
    """The started cells' probe records (every process waited for, or
    killed at the time limit)."""
    from repro_torch.configs import preferred_rules_name
    from repro_torch.core import cost_model

    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LAUNCH_DRYRUN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    cells = []
    for (arch, shape, rules), p, out in zip(LAUNCH_DRYRUN_CELLS, procs, outs):
        check(p.returncode == 0, f"launch (d): dry run {arch} {shape} {rules} "
              f"failed ({p.returncode}): {out[-3000:]}")
        name = preferred_rules_name(arch, shape) if rules == "preferred" else rules
        rec = json.loads((cost_model.DRYRUN_DIR / "pod16x16"
                          / f"{arch}__{shape}__{name}__probe.json").read_text())
        check(rec["flops_per_device"] > 0 and rec["num_devices"] == 256,
              f"launch (d): {arch} {shape} {name}: {rec}")
        cells.append(dict(arch=arch, shape=shape, rules=name, asked=rules,
                          compute_ms=rec["compute_seconds"] * 1e3,
                          memory_ms=rec["memory_seconds"] * 1e3,
                          collective_ms=rec["collective_seconds"] * 1e3,
                          dominant=rec["dominant"], fits_hbm=rec["fits_hbm"],
                          peak_bytes=rec["memory_stats"]["peak_bytes"],
                          flops_per_device=rec["flops_per_device"],
                          bytes_per_device=rec["bytes_per_device"],
                          collective_wire_bytes=rec["collective_wire_bytes"],
                          collectives=rec["collectives"],
                          useful_flops_ratio=rec["useful_flops_ratio"],
                          trace_seconds=rec["trace_seconds"]))
    return cells


def launch_phase(dev, counters, procs):
    """(a)-(d) of LAUNCH_*: examples.train_100m on the card, its resume, a
    sharded step on a world-1 NCCL mesh, the dry run's flops against
    FlopCounterMode, and the dry run at full shapes on the fake mesh with
    the roofline section's rows.  ``procs`` are (d)'s processes
    (``_start_dryrun_cells``), started earlier on the host's spare cores."""
    import io
    import tempfile

    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.benchmarks import roofline
    from repro_torch.data import random_batch
    from repro_torch.examples import train_100m
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import init_params
    from repro_torch.models.spec import ParamSpec, tree_leaves
    from repro_torch.sharding.rules import DEFAULT_RULES, distribute_tree, mesh_context
    from repro_torch.train import (OptConfig, TrainState, adamw_init, make_train_step,
                                   train_state_specs)

    t_phase = time.perf_counter()
    out = {}
    cfg = train_100m.model_100m()
    is_t = lambda x: isinstance(x, torch.Tensor)  # noqa: E731
    work = Path(tempfile.mkdtemp(prefix="train_100m_", dir=ROOT / "build"))
    was_det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        # (a) the CLI's run, then a run saving at LAUNCH_RESUME_AT, resumed
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            state, losses = train_100m.main(["--steps", str(LAUNCH_STEPS), "--ckpt",
                                             str(work / "cli"), "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = read(counters)
        losses = [float(x) for x in losses]
        check(len(losses) == LAUNCH_STEPS and all(np.isfinite(losses)),
              f"launch (a): losses {losses[:5]} ... ({len(losses)})")
        first, last = float(np.mean(losses[:25])), float(np.mean(losses[-25:]))
        check(last < first, f"launch (a): the loss did not fall ({first} -> {last})")
        check(sum(launches.values()) == 0,
              f"launch (a): the plain route launched kernels {launches}")
        ckpts = sorted(p.name for p in (work / "cli").glob("step_*"))
        check(ckpts == ["step_00000200", "step_00000300"], f"launch (a): checkpoints {ckpts}")
        # a run stopped after LAUNCH_RESUME_AT (its checkpoint there), resumed
        split = work / "split"
        _, head = train_100m.train(cfg, steps=LAUNCH_STEPS, save_every=LAUNCH_RESUME_AT,
                                   ckpt=str(split), stop_after=LAUNCH_RESUME_AT,
                                   device=dev, verbose=False)
        _, tail = train_100m.train(cfg, steps=LAUNCH_STEPS, save_every=LAUNCH_RESUME_AT,
                                   ckpt=str(split), resume=True, device=dev, verbose=False)
        resumed, at_stop = float(tail[-1]), float(head[-1])
        check(len(head) == LAUNCH_RESUME_AT and len(tail) == LAUNCH_STEPS - LAUNCH_RESUME_AT
              and abs(resumed - losses[-1]) <= LAUNCH_RESUME_RTOL * abs(losses[-1]),
              f"launch (a): resumed final loss {resumed} against {losses[-1]}")
        out["a"] = dict(model=cfg.name, params=cfg.param_count(), steps=LAUNCH_STEPS,
                        batch=4, seq=128, wall_s=wall,
                        tokens_per_s=LAUNCH_STEPS * 4 * 128 / wall,
                        ms_per_step=wall / LAUNCH_STEPS * 1e3,
                        max_memory_allocated=peak, loss_first=losses[0],
                        loss_last=losses[-1], loss_mean_first_25=first,
                        loss_mean_last_25=last, checkpoints=ckpts,
                        launches=launches, resumed_from=LAUNCH_RESUME_AT,
                        resumed_final_loss=resumed,
                        resumed_equals_uninterrupted_bitwise=resumed == losses[-1],
                        loss_at_stop=at_stop,
                        loss_at_stop_equals_cli_bitwise=at_stop == losses[LAUNCH_RESUME_AT - 1],
                        deterministic_algorithms=True, resume_rtol=LAUNCH_RESUME_RTOL)
    finally:
        torch.use_deterministic_algorithms(was_det)
        shutil.rmtree(work, ignore_errors=True)

    # (b) one sharded step on a world-1 NCCL (1, 1) mesh, the model in
    # float32 (the DTensor route computes the projections as einsums and the
    # embedding as a masked gather: the same values, not the same kernels)
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    opt = OptConfig(lr=6e-4, warmup_steps=30, total_steps=LAUNCH_STEPS)
    params = init_params(cfg32, 0, device=dev)
    state = TrainState(params, adamw_init(params, opt))
    host = random_batch(cfg32, 4, 128, np.random.default_rng(0))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    plain_step = make_train_step(cfg32, opt)
    new0, met0 = plain_step(state, batch)
    torch.cuda.synchronize()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_test_mesh(1, 1)
        sstate = distribute_tree(state, train_state_specs(cfg, opt), mesh, DEFAULT_RULES)
        bspecs = {k: ParamSpec(tuple(v.shape), ("batch", "seq"), dtype=v.dtype)
                  for k, v in batch.items()}
        sbatch = distribute_tree(batch, bspecs, mesh, DEFAULT_RULES)
        times = []
        with mesh_context(mesh):
            for _ in range(2):                # the first pays DTensor's set-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                new1, met1 = make_train_step(cfg32, opt, DEFAULT_RULES)(sstate, sbatch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        loss0, loss1 = float(met0["loss"]), float(met1["loss"].full_tensor())
        lr = float(met0["lr"])
        # beyond one ulp of each parameter's value
        errs = [float(((a - b.full_tensor()).abs()
                       - (torch.nextafter(a.abs(), torch.full_like(a, float("inf"))) - a.abs())).max())
                for a, b in zip(tree_leaves(new0.params, is_t), tree_leaves(new1.params, is_t),
                                strict=True)]
        check(abs(loss1 - loss0) <= TRAIN_LOSS_RTOL * abs(loss0)
              and max(errs) <= LAUNCH_SHARDED_TOL_OF_LR * lr,
              f"launch (b): sharded step loss {loss1} vs {loss0}, params err {max(errs)} "
              f"(lr {lr})")
        out["b"] = dict(backend=dist.get_backend(), mesh=[1, 1], dtype="float32",
                        loss=loss1, loss_unsharded=loss0, loss_bitwise=loss1 == loss0,
                        params_max_err_beyond_ulp=max(errs), lr=lr,
                        loss_rtol=TRAIN_LOSS_RTOL, params_tol_of_lr=LAUNCH_SHARDED_TOL_OF_LR,
                        sharded_step_s=times)
        del sstate, sbatch, new1
    finally:
        dist.destroy_process_group()

    # (c) the dry run's flops on a (1, 1) fake mesh against FlopCounterMode
    dryrun.init_fake_world(1)
    try:
        with dryrun.extra_shape("train_100m", 128, 4, "train") as shape:
            _, counts, secs = dryrun.count_cell(cfg32, shape, make_test_mesh(1, 1),
                                                DEFAULT_RULES)
    finally:
        dist.destroy_process_group()
    with FlopCounterMode(display=False) as fc:
        plain_step(state, batch)
    torch.cuda.synchronize()
    check(counts["flops"] == fc.get_total_flops(),
          f"launch (c): dry run {counts['flops']} flops, FlopCounterMode "
          f"{fc.get_total_flops()}")
    out["c"] = dict(flops=counts["flops"], flop_counter_mode=fc.get_total_flops(),
                    bytes=counts["bytes"], peak_bytes=counts["memory_stats"]["peak_bytes"],
                    trace_seconds=secs)
    del state, params, new0
    torch.cuda.empty_cache()

    # (d) the dry run at full shapes on the fake 256-rank mesh
    t0 = time.perf_counter()
    out["d"] = _dryrun_cells(procs)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        roofline.main()
    rows = buf.getvalue().strip().splitlines()
    check(len(rows) == len(out["d"])
          and all(r.startswith("roofline_") and not r.startswith("roofline_missing")
                  for r in rows),
          f"launch (d): roofline rows {rows}")
    out["roofline_rows"] = rows
    out["dryrun_wait_after_c_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    return dict(phase="launch", **out)


def train_step_phase(arch, dev, counters):
    """The training launcher at full width and depth on the card (timed
    step by step, its kernel launches counted: the plain route launches
    none), the plain attention's or scan's share of a step, the kernel
    route's guard, and a float32 twin of the first layers, card against CPU
    and remat "full" against "none"."""
    import contextlib

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch

    t_phase = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "train_step: float32 matmuls must not take TF32")
    cfg = get_config(arch)
    check(cfg.remat == "full" and not cfg.use_pallas
          and not (cfg.ssm is not None and cfg.ssm.use_pallas)
          and cfg.compute_dtype == torch.bfloat16 and cfg.param_dtype == torch.float32,
          f"train_step {arch}: not the plain route, remat full, bf16 over float32")
    steps = []
    make = launch.make_train_step

    def timed_steps(cfg_, opt_cfg):
        step = make(cfg_, opt_cfg)

        def run(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, batch)
            torch.cuda.synchronize()
            steps.append(dict(ms=(time.perf_counter() - t0) * 1e3, loss=float(met["loss"]),
                              grad_norm=float(met["grad_norm"]), lr=float(met["lr"])))
            return state, met
        return run

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset(counters)
    launch.make_train_step = timed_steps
    try:
        with contextlib.redirect_stdout(sys.stderr):
            state = launch.main(["--arch", arch, "--full", "--device", str(dev),
                                 "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
                                 "--seq", str(TRAIN_SEQ), "--seed", "0"])
        torch.cuda.synchronize()
    finally:
        launch.make_train_step = make
    launches = read(counters)
    peak = torch.cuda.max_memory_allocated()
    check(len(steps) == TRAIN_STEPS and all(np.isfinite(s["loss"]) and s["loss"] > 0
                                            for s in steps),
          f"train_step {arch}: steps {steps}")
    check(sum(launches.values()) == 0,
          f"train_step {arch}: the plain route launched kernels {launches}")
    step_ms = float(np.mean([s["ms"] for s in steps[1:]]))

    # the kernel route is forward only: with an input requiring grad it
    # raises on the card and launches nothing
    q = torch.zeros((1, 64, 2, 64), device=dev, requires_grad=True)
    try:
        ops.flash_attention(q, q.detach(), q.detach())
        guard = False
    except RuntimeError as e:
        guard = "no backward" in str(e)
    check(guard and sum(read(counters).values()) == 0,
          f"train_step {arch}: the kernel route ran under autograd")

    plain = plain_route_ms(cfg, dev)
    plain["share_of_step"] = plain["per_step_ms"] / step_ms

    # float32 twin: the first layers of the trained parameters, one batch
    # of the pipeline at S TRAIN_TWIN_SEQ
    twin_cfg = dataclasses.replace(cfg, num_layers=TRAIN_TWIN_LAYERS,
                                   compute_dtype=torch.float32)
    twin = first_layers(state.params, TRAIN_TWIN_LAYERS)
    raw = SyntheticLMStream(DataConfig(seq_len=TRAIN_TWIN_SEQ, global_batch=TRAIN_BATCH,
                                       seed=0), cfg).batch_at(0)
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    reset(counters)                    # plain_route_ms timed the kernels
    card_loss, card_grads = loss_and_grads(twin, {k: v.to(dev) for k, v in batch.items()},
                                           twin_cfg)
    none_loss, none_grads = loss_and_grads(
        twin, {k: v.to(dev) for k, v in batch.items()},
        dataclasses.replace(twin_cfg, remat="none"))
    check(sum(read(counters).values()) == 0, f"train_step {arch}: the twin launched kernels")
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = loss_and_grads(tensors_to(twin, "cpu"), batch, twin_cfg)
    cpu_s = time.perf_counter() - t0
    errs = leaf_errs(card_grads, cpu_grads)
    remat_errs = leaf_errs(none_grads, [g.cpu() for g in card_grads])
    remat_equal = bool(torch.equal(card_loss, none_loss)) and all(
        torch.equal(a, b) for a, b in zip(card_grads, none_grads))
    check(abs(float(card_loss) - float(cpu_loss)) <= TRAIN_LOSS_RTOL * abs(float(cpu_loss))
          and max(errs) <= TRAIN_GRAD_TOL and max(remat_errs) <= TRAIN_GRAD_TOL,
          f"train_step {arch}: the float32 twin differs: loss {float(card_loss)} vs "
          f"{float(cpu_loss)}, worst leaf {max(errs)}, remat none vs full {max(remat_errs)}")
    total = torch.cuda.get_device_properties(0).total_memory
    rec = dict(phase="train_step", arch=arch, card=card_name_and_power(),
               params=cfg.param_count(), layers=cfg.num_layers, d_model=cfg.d_model,
               vocab=cfg.vocab_size, batch=TRAIN_BATCH, seq=TRAIN_SEQ, cut=TRAIN_CUT,
               compute_dtype="bfloat16", param_dtype="float32", moment_dtype="float32",
               remat=cfg.remat, route="plain (use_pallas=False)", steps=steps,
               step_ms=step_ms, step_ms_of="steps 2-3, host clock, synchronized",
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
               peak_memory_gb=peak / 1e9, card_memory_gb=total / 1e9,
               launches=launches, kernel_route_guard_raises=guard,
               plain_route=plain,
               cpu_twin=dict(layers=TRAIN_TWIN_LAYERS, seq=TRAIN_TWIN_SEQ, dtype="float32",
                             tolerance=dict(grad_leaf=TRAIN_GRAD_TOL, loss_rtol=TRAIN_LOSS_RTOL),
                             loss_card=float(card_loss), loss_cpu=float(cpu_loss),
                             leaves=len(errs), max_leaf_err=max(errs), cpu_s=cpu_s,
                             remat_full_vs_none_bit_equal=remat_equal,
                             remat_full_vs_none_max_leaf_err=max(remat_errs)),
               phase_s=time.perf_counter() - t_phase)
    del state, twin, card_grads, none_grads
    torch.cuda.empty_cache()
    return rec


class FixedClock:
    """An executor whose trials last a fixed time per arch (the cost model's
    estimate), so the service's trial order does not hang on the clock."""

    def __init__(self, executor, seconds: dict):
        self.executor, self.seconds = executor, seconds
        self.calls: list = []

    def run(self, tenant, arch):
        z, _ = self.executor.run(tenant, arch)
        self.calls.append((tenant.tenant_id, arch, z))
        return z, self.seconds[arch]


def service_protocol_f32(device, example, svc_mod):
    """The example's protocol in float32 on ``device`` with a FixedClock:
    (prior mu and K, the trials of both services as tuples, the executor's
    (tenant, arch, z) calls)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.cost_model import CostModel

    smoke = svc_mod.get_smoke_config
    svc_mod.get_smoke_config = lambda a: dataclasses.replace(
        get_smoke_config(a), compute_dtype=torch.float32)
    try:
        chips = example.fleet().slices[0].chips
        seconds = {a: CostModel().trial_seconds(a, "train_4k",
                                                steps=example.SVC.steps_per_trial,
                                                chips=chips, cfg=get_smoke_config(a))
                   for a in example.ARCHS}
        ex = FixedClock(svc_mod.RealExecutor(example.SVC, device=device), seconds)
        (mu, K), first, restored = example.run(ex, device)
    finally:
        svc_mod.get_smoke_config = smoke
    return mu, K, [dataclasses.astuple(t) for t in first.trials + restored.trials], ex.calls


def service_phase(dev, counters):
    """The example's protocol (real trials) on the card, each decision and
    trial timed and the readout launches counted; then its float32 twin on
    the card twice and on the CPU, with a fixed clock: equal trial
    sequences, z to SERVICE_Z_RTOL; bf16 z against float32 z recorded."""
    from repro_torch.core import service as svc_mod
    from repro_torch.examples import multi_tenant_service as example

    t_phase = time.perf_counter()
    decisions, trials = [], []
    choose, run = svc_mod.AutoMLService._choose, svc_mod.RealExecutor.run

    def timed_choose(self):
        reads = not self.selected.all()
        t0 = time.perf_counter()
        m = choose(self)
        decisions.append(dict(ms=(time.perf_counter() - t0) * 1e3, reads=reads))
        return m

    def timed_run(self, tenant, arch):
        z, wall = run(self, tenant, arch)
        trials.append(dict(tenant=tenant.tenant_id, arch=arch, z=z, wall_s=wall))
        return z, wall

    reset(counters)
    svc_mod.AutoMLService._choose, svc_mod.RealExecutor.run = timed_choose, timed_run
    try:
        (mu, _), first, restored = example.run(
            svc_mod.RealExecutor(example.SVC, device=dev), dev)
        torch.cuda.synchronize()
    finally:
        svc_mod.AutoMLService._choose, svc_mod.RealExecutor.run = choose, run
    launches = read(counters)
    reading = sum(d["reads"] for d in decisions)
    n_prior = len(example.PRIOR_TENANTS) * len(example.ARCHS)
    service_trials = first.trials + restored.trials
    check(len(trials) == n_prior + len(service_trials) == n_prior + len(example.ARCHS)
          * len(example.TENANTS) and all(0.0 < t["z"] <= 1.0 for t in trials),
          f"service: {len(trials)} trainings, z {[t['z'] for t in trials]}")
    check(launches["gp_readout"] == reading > 0
          and sum(launches.values()) == launches["gp_readout"],
          f"service: launches {launches} for {reading} decisions that read the posterior")
    reading_ms = [d["ms"] for d in decisions if d["reads"]]

    # the float32 twin: card twice, then the CPU
    twin_runs = {"card_a": service_protocol_f32(dev, example, svc_mod),
                 "card_b": service_protocol_f32(dev, example, svc_mod)}
    bit_equal = twin_runs["card_a"][2] == twin_runs["card_b"][2]
    deterministic = False
    if not bit_equal:
        # two card runs parted: rerun both with deterministic algorithms
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            twin_runs["card_c"] = service_protocol_f32(dev, example, svc_mod)
            twin_runs["card_d"] = service_protocol_f32(dev, example, svc_mod)
        finally:
            torch.use_deterministic_algorithms(False)
        deterministic = True
        check(twin_runs["card_c"][2] == twin_runs["card_d"][2],
              "service: two deterministic card runs of the float32 twin part")
    card = twin_runs["card_c" if deterministic else "card_a"]
    t0 = time.perf_counter()
    cpu = service_protocol_f32("cpu", example, svc_mod)
    cpu_s = time.perf_counter() - t0
    key = lambda tr: tr[:6]            # model, tenant, arch, slice, start, end
    z_err = max(abs(a[6] - b[6]) / abs(b[6]) for a, b in zip(card[2], cpu[2]))
    prior_err = max(float(np.max(np.abs(card[0] - cpu[0]) / np.abs(cpu[0]))),
                    float(np.max(np.abs(card[1] - cpu[1]) / np.abs(cpu[1]).max())))
    check([key(t) for t in card[2]] == [key(t) for t in cpu[2]]
          and z_err <= SERVICE_Z_RTOL and prior_err <= SERVICE_Z_RTOL,
          f"service: the float32 twin parts card from CPU: z {z_err}, prior {prior_err}, "
          f"card {[key(t) for t in card[2]]} cpu {[key(t) for t in cpu[2]]}")
    # bf16 (the example's run) against float32 (the card twin), on the
    # prior's trainings, which both make in the same order
    bf16_z = [t["z"] for t in trials[:n_prior]]
    f32_z = [c[2] for c in card[3][:n_prior]]
    return dict(phase="service", card=card_name_and_power(),
                protocol=dict(archs=example.ARCHS, tenants=len(example.TENANTS),
                              prior_tenants=len(example.PRIOR_TENANTS),
                              svc=dataclasses.asdict(example.SVC),
                              crash_after=example.CRASH_AFTER, models=first.n,
                              fleet="partition_pod(256, 2, speeds=[1.0, 0.6])"),
                compute_dtype="bfloat16", prior_mean=[float(v) for v in mu],
                trainings=trials,
                trial_wall_s=dict(mean=float(np.mean([t["wall_s"] for t in trials])),
                                  max=float(np.max([t["wall_s"] for t in trials]))),
                trials=[dict(model=t.model, tenant=t.tenant, arch=t.arch, slice=t.slice_id,
                             t_start=t.t_start, t_end=t.t_end, z=t.z) for t in service_trials],
                decisions=len(decisions), decisions_reading_posterior=reading,
                # the first decision loads the readout kernel's library
                decision_ms=dict(first=reading_ms[0],
                                 median_after_first=float(np.median(reading_ms[1:])),
                                 mean_after_first=float(np.mean(reading_ms[1:])),
                                 max_after_first=float(np.max(reading_ms[1:]))),
                launches=launches,
                float32_twin=dict(clock="fixed: the cost model's estimate per arch",
                                  tolerance=dict(z_rtol=SERVICE_Z_RTOL),
                                  card_runs_bit_equal=bit_equal,
                                  deterministic_rerun=deterministic,
                                  trials_equal_cpu=True, max_z_rel_err=z_err,
                                  prior_max_rel_err=prior_err, cpu_s=cpu_s,
                                  trials=len(card[2])),
                bf16_vs_float32_z=dict(of="the prior's 8 trainings, card",
                                       bf16=bf16_z, float32=f32_z,
                                       max_rel_diff=max(abs(a - b) / b
                                                        for a, b in zip(bf16_z, f32_z))),
                phase_s=time.perf_counter() - t_phase)


def sass(library: Path, _build) -> str:
    """The SASS of a built library (``cuobjdump -sass`` from the CUDA
    toolkit)."""
    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).with_name("cuobjdump"))
    return subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def count_by_function(text: str, opcodes=FP64_OPCODES) -> dict[str, int]:
    """Instructions of ``opcodes`` in each function of a SASS listing (by
    default DFMA, DADD and DMUL; None: every instruction but NOPs)."""
    if opcodes is None:
        pattern = r"/\*[0-9a-f]{4}\*/\s+(?!NOP\b)\S"
    else:
        pattern = r"\b(?:" + "|".join(opcodes) + r")\b"
    return {block.split("\n", 1)[0].strip(): len(re.findall(pattern, block))
            for block in re.split(r"\n\s*Function : ", text)[1:]}


def fp64_counted_ptx(ptx: str) -> tuple[str, int]:
    """probe_tau's PTX with %fp64_n declared, set to 0 and raised by one
    after each FP64 fma, add, sub and mul, under that instruction's own
    guard; and how many such instructions the function holds."""
    out, counted, state = [], 0, "outside"
    for line in ptx.splitlines():
        text = line.strip()
        if state == "outside" and text.startswith(".visible .entry probe_tau("):
            state = "head"
        elif state == "head" and text == "{":
            out += [line, "\t.reg .b32 \t%fp64_n;"]
            state = "declarations"
            continue
        elif state == "declarations" and text and not text.startswith("."):
            out.append("\tmov.u32 \t%fp64_n, 0;")
            state = "body"
        elif state == "body" and line == "}":
            state = "after"
        out.append(line)
        m = FP64_PTX_OP.match(line) if state == "body" else None
        if m:
            out.append(f"{m.group(1)}{m.group(2) or ''}add.u32 \t%fp64_n, %fp64_n, 1;")
            counted += 1
    check(state == "after", "build: probe_tau not found in the FP64 probe's PTX")
    return "\n".join(out) + "\n", counted


def fp64_probe(_build) -> dict:
    """Builds FP64_PROBE with the EIrate kernels' flags, once for a given
    probe, flags and ei_column.cuh (build/chip_smoke/fp64_probe-<hash>/,
    reused after): the SASS of probe_tau as it is, and the counting PTX
    (fp64_counted_ptx) through ptxas.  Checks that the PTX holds as many
    FP64 fma, add, sub and mul as the SASS holds DFMA, DADD and DMUL, so
    each counts one SASS instruction, and that every kernel of the three
    EIrate libraries holds the same FP64 instructions as probe_tau (one
    inlined term).  Loads the counting probe for fp64_executed and returns
    what the build phase reports: the static counts, and the executed count
    at a u on each path of ndtr (erf: |u| < 1; erfc above) and of exp."""
    flags = [f for f in _build.flags("ei_score")
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    key = hashlib.sha256("\0".join([FP64_PROBE, *flags]).encode())
    key.update((_build.SRC_DIR / "ei_column.cuh").read_bytes())
    work = ROOT / "build" / "chip_smoke" / f"fp64_probe-{key.hexdigest()[:16]}"
    plain, counted = work / "plain.cubin", work / "counted.cubin"
    built = not counted.exists()
    if built:
        work.mkdir(parents=True, exist_ok=True)
        (work / "probe.cu").write_text(FP64_PROBE)
        common = [_build._nvcc(), *flags, "-I", str(_build.SRC_DIR)]
        procs = [subprocess.Popen([*common, *mode, str(work / "probe.cu")],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for mode in (["-cubin", "-o", str(plain)],
                              ["-DFP64_COUNTED", "-ptx", "-o", str(work / "counted.ptx")])]
        for proc in procs:
            log, _ = proc.communicate(timeout=300)
            check(proc.returncode == 0, f"build: the FP64 probe failed:\n{log}")
        ptx, n_ptx = fp64_counted_ptx((work / "counted.ptx").read_text())
        (work / "counted_rw.ptx").write_text(ptx)
        (work / "n_ptx").write_text(str(n_ptx))
        ptxas = Path(_build._nvcc()).with_name("ptxas")
        proc = subprocess.run([str(ptxas), "-arch=sm_90a", "-O3", "-o",
                               str(counted.with_suffix(".tmp")), str(work / "counted_rw.ptx")],
                              capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0,
              f"build: ptxas refused the counting probe:\n{proc.stdout}{proc.stderr}")
        os.replace(counted.with_suffix(".tmp"), counted)
    listing = sass(plain, _build)
    static = count_by_function(listing)["probe_tau"]
    n_ptx = int((work / "n_ptx").read_text())
    check(n_ptx == static, f"build: probe_tau holds {n_ptx} FP64 fma/add/sub/mul "
          f"in PTX but {static} DFMA/DADD/DMUL in SASS")
    libraries = {src: count_by_function(sass(_build.library_path(src), _build))
                 for src in ("ei_score", "ei_classes", "ei_topk")}
    check(all(libraries.values()) and all(
        c == static for by_kernel in libraries.values() for c in by_kernel.values()),
        f"build: the EIrate kernels' FP64 instructions {libraries} are not "
        f"probe_tau's {static}")

    FP64_PROBE_STATE.update(load_function(counted, "probe_tau", "the counting probe"))
    # ndtr's erf branch (|u| < 1), its erfc branch on both sides, and exp's
    # far tail (exp's argument below -708: |u| > 37.6)
    at = {"erf": 0.5, "erfc": 2.0, "erfc_negative": -2.0, "exp_tail": 40.0}
    ran = fp64_executed(torch.tensor(list(at.values()), device="cuda")).tolist()
    return dict(built=built, probe_tau_static=static, ptx_counted=n_ptx,
                executed_at_u={k: dict(u=u, fp64=c) for (k, u), c in zip(at.items(), ran)},
                # every instruction of probe_tau but NOPs, its own loads and
                # stores too, and the UMOVs among them that load the
                # polynomials' double constants: the SM issues them all
                probe_instructions=count_by_function(listing, None)["probe_tau"],
                probe_umov=count_by_function(listing, ("UMOV",))["probe_tau"],
                libraries=libraries)


def load_function(cubin: Path, name: str, what: str) -> dict:
    """The kernel ``name`` of ``cubin``, loaded into the primary context
    through the driver API: libcuda, the CUfunction and its module."""
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuLaunchKernel.argtypes = [ctypes.c_void_p, *[ctypes.c_uint] * 7,
                                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    torch.zeros(1, device="cuda")          # the primary context, current
    module, func = ctypes.c_void_p(), ctypes.c_void_p()
    for call, args in (("cuModuleLoadData", (ctypes.byref(module), cubin.read_bytes())),
                       ("cuModuleGetFunction", (ctypes.byref(func), module,
                                                name.encode()))):
        err = getattr(cuda, call)(*args)
        check(err == 0, f"build: {call} of {what}: CUresult {err}")
    return dict(cuda=cuda, func=func, module=module)


def empty_probe(_build) -> dict:
    """Builds EMPTY_PROBE with the readout's flags, once for a given probe
    and flags (build/chip_smoke/empty_probe-<hash>/, reused after), and
    loads it for empty_launch.  Returns whether it was built."""
    flags = [f for f in _build.flags("gp_readout")
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    key = hashlib.sha256("\0".join([EMPTY_PROBE, *flags]).encode())
    work = ROOT / "build" / "chip_smoke" / f"empty_probe-{key.hexdigest()[:16]}"
    cubin = work / "empty.cubin"
    built = not cubin.exists()
    if built:
        work.mkdir(parents=True, exist_ok=True)
        (work / "empty.cu").write_text(EMPTY_PROBE)
        proc = subprocess.run([_build._nvcc(), *flags, "-cubin", "-o",
                               str(cubin.with_suffix(".tmp")), str(work / "empty.cu")],
                              capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0,
              f"build: the empty probe failed:\n{proc.stdout}{proc.stderr}")
        os.replace(cubin.with_suffix(".tmp"), cubin)
    EMPTY_PROBE_STATE.update(load_function(cubin, "empty_kernel", "the empty probe"))
    return dict(built=built)


def empty_launch() -> None:
    """One launch of the empty probe on the current stream: one block of
    256 threads, no parameters."""
    st = EMPTY_PROBE_STATE
    err = st["cuda"].cuLaunchKernel(st["func"], 1, 1, 1, 256, 1, 1, 0,
                                    torch.cuda.current_stream().cuda_stream, None, None)
    check(err == 0, f"empty_launch: cuLaunchKernel returned CUresult {err}")


def fp64_executed(u: torch.Tensor) -> torch.Tensor:
    """The FP64 instructions (DFMA, DADD, DMUL) the card executes for
    tau(u) at each element of float32 ``u`` on the card: one launch of the
    counting probe (fp64_probe), one thread an element."""
    n = u.numel()
    u = u.contiguous()
    y = torch.empty_like(u)
    count = torch.zeros(n, dtype=torch.int32, device=u.device)
    if n == 0:
        return count
    vals = [ctypes.c_void_p(u.data_ptr()), ctypes.c_void_p(y.data_ptr()),
            ctypes.c_void_p(count.data_ptr()), ctypes.c_int(n)]
    params = (ctypes.c_void_p * 4)(*[ctypes.cast(ctypes.pointer(v), ctypes.c_void_p)
                                     for v in vals])
    st = FP64_PROBE_STATE
    err = st["cuda"].cuLaunchKernel(st["func"], (n + 255) // 256, 1, 1, 256, 1, 1, 0,
                                    torch.cuda.current_stream().cuda_stream,
                                    params, None)
    check(err == 0, f"fp64_executed: cuLaunchKernel returned CUresult {err}")
    torch.cuda.synchronize()
    check(bool((count > 0).all()), "fp64_executed: a thread counted no FP64 work")
    return count


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch import _build
    from repro_torch.core import (ControlPlane, azure_problem, regret_curves,
                                  simulate, synthetic_matern_problem)
    from repro_torch import obs, stream
    from repro_torch.core.tenancy import _matern_block_chol, _matern_draw
    from repro_torch.devplane import DevPlaneEngine, two_class_registry
    from repro_torch.kernels import ei_score, gp_readout, ops, ref
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ssd as ssd_mod
    from repro_torch.shardgp import ShardedScorer

    dev = torch.device("cuda")
    # float32 products in full float32 (the default, stated): the CPU twins
    # are held to the card at float32 tolerance
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    per_source = _build.build()
    regs = {name: [ln.strip() for ln in log.splitlines()
                   if "Used" in ln and "registers" in ln or "spill" in ln]
            for name, log in _build.BUILD_LOG.items()}
    listings = {src: sass(_build.library_path(src), _build)
                for src in ("flash_attention_sm90", "ssd_sm90", "flash_attention", "ssd")}
    hgmma = {src: sum(count_by_function(text, ("HGMMA",)).values())
             for src, text in listings.items()}
    # the float32 routes' products are tf32 HGMMAs: every HGMMA that writes
    # registers (ptxas adds one 64x8x16.F16 into RZ a kernel, which computes
    # nothing)
    forms = {src: sorted(set(re.findall(r"\bHGMMA\.(\S+) R\d", text)))
             for src, text in listings.items()}
    hgmma_tf32 = {src: len(re.findall(r"\bHGMMA\.\S*TF32 R\d", listings[src]))
                  for src in ("flash_attention", "ssd")}
    check(all(hgmma.values()) and all(hgmma_tf32.values())
          and all(f.endswith(".TF32") for src in hgmma_tf32 for f in forms[src]),
          f"build: HGMMA instructions by library {hgmma}, TF32 ones {hgmma_tf32}, "
          f"forms {forms}")
    fp64 = fp64_probe(_build)
    empty = empty_probe(_build)
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              per_source=per_source, ptxas=regs, hgmma_instructions=hgmma,
              hgmma_tf32_instructions=hgmma_tf32,
              hgmma_forms=forms,
              ei_fp64_instructions=fp64, empty_probe=empty,
              libraries=[str(_build.library_path(s).relative_to(ROOT))
                         for s in _build.sources()]))

    rng = np.random.default_rng(0)
    ei_cases = [eirate_case(*c, rng, dev, ei_score, ref) for c in (
        ("paper_disjoint", 50, 2500, "disjoint"),
        ("paper_dense", 50, 2500, "dense"),
        ("paper_tie", 50, 2500, "tie"),
        ("service_disjoint", 1000, 100_000, "disjoint"),
        ("service_dense", 1000, 100_000, "dense"))]
    ro_cases = [readout_case(k, n, sd, rng, dev, gp_readout, ref)
                for k, n in ((0, 50), (50, 50), (512, 2500), (1024, 100_000))
                for sd in (False, True)]
    # n no multiple of 4; column slices of a wider W 1, 2 and 4 columns in
    # (4-byte loads, then 16-byte bulk copies); a shard's slice of
    # readout_decide's W over 4 shards (its blocks fewer than the SMs)
    ro_cases += [readout_case(k, n, False, rng, dev, gp_readout, ref, offset, width)
                 for k, n, offset, width in (
                     (300, 40_001, None, None), (256, 40_000, 1, None),
                     (256, 40_000, 2, None), (256, 40_000, 4, None),
                     (READOUT_SHAPE[0], READOUT_SHAPE[1] // 4, READOUT_SHAPE[1] // 4,
                      READOUT_SHAPE[1]))]
    floor_ms = launch_floor_ms()
    check({c["path"] for c in ro_cases} == set(gp_readout.PATHS),
          f"kernels: the readout cases took the paths {[c['path'] for c in ro_cases]}")
    topk_cases = [topk_case(*c, TOPK, rng, dev, ei_score, ref) for c in (
        ("paper_disjoint", 50, 2500, "disjoint"),
        ("paper_dense", 50, 2500, "dense"),
        ("paper_tie", 50, 2500, "tie"),
        ("service_disjoint", 1000, 100_000, "disjoint"),
        ("service_dense", 1000, 100_000, "dense"),
        ("k_gt_n", 50, 3, "dense"))]
    classes_cases = [classes_case(*c, rng, dev, ei_score, ref) for c in (
        ("paper_disjoint", 2, 50, 2500, "disjoint"),
        ("service_disjoint", CLASSES_C, 1000, 100_000, "disjoint"),
        ("service_dense", CLASSES_C, 1000, 100_000, "dense"),
        ("memory_gate", 2, 50, 2500, "gate"),
        ("paper_tie", 3, 50, 2500, "tie"),
        ("c1_rate1_overhead0", 1, 50, 2500, "c1"))]
    emit(dict(phase="kernels", tolerance=0.0,
              tolerance_reason="each kernel does its plain version's arithmetic "
              "step for step: no multiply-add contraction (-fmad=false), sums in "
              "ascending order, erf/erfc/exp in double rounded once, IEEE sqrt, "
              "the same per-column tenant sum in all three EIrate kernels, the "
              "same lowest-index rule in every top-k; so both are held "
              "bit-equal, ids included, and every class row bit-equal to the "
              "EIrate kernel with that cost row",
              eirate=ei_cases, gp_readout=ro_cases, gp_readout_launch_floor_ms=floor_ms,
              eirate_topk=topk_cases,
              eirate_classes=classes_cases))

    counters = {"eirate": (ei_score, "launches"),
                "eirate_topk": (ei_score, "topk_launches"),
                "eirate_classes": (ei_score, "classes_launches"),
                "gp_readout": (gp_readout, "launches")}
    fig5 = synthetic_matern_problem(50, 50, seed=0)
    res, rec = episode("episode_fig5", fig5, "mdmt", 4, FIG5_HORIZON, counters,
                       simulate, regret_curves)
    main_launches = rec["launches"]
    policy_trials = sum(t.user_hint == -1 for t in res.trials)
    check(main_launches["eirate"] == res.decisions == policy_trials,
          f"episode_fig5: {main_launches['eirate']} EIrate launches for "
          f"{res.decisions} decisions")
    check(main_launches["gp_readout"] > 0, "episode_fig5: no readout launch")
    emit(rec)

    dense = synthetic_matern_problem(1, 2048, seed=0)
    res, rec = episode("episode_dense", dense, "mdmt", 4, DENSE_HORIZON, counters,
                       simulate, regret_curves)
    check(rec["launches"]["eirate"] == res.decisions
          and rec["launches"]["gp_readout"] >= res.decisions,
          f"episode_dense: launches {rec['launches']} for {res.decisions} decisions")
    emit(rec)

    azure = azure_problem(0)
    for policy in ("round_robin", "random"):
        _, rec = episode("baselines", azure, policy, 4, np.inf, counters,
                         simulate, regret_curves)
        check(rec["launches"]["gp_readout"] > 0, "baselines: no readout launch")
        emit(rec)

    emit(batched_phase(dev, counters))

    figures = figures_phase(dev, counters)
    emit(figures)

    emit(readout_decide_phase(rng, dev, ShardedScorer, ops, ref, counters))

    runs, rec = churn_phase(0, dev, ControlPlane, _matern_block_chol,
                            _matern_draw, counters, ei_score, ref)
    emit(rec)
    main_launches["eirate_topk"] = runs["a"]["launches"]["eirate_topk"]

    dp_runs, dp = devplane_phase(dev, counters, DevPlaneEngine,
                                 two_class_registry, stream, ei_score, ref)
    emit(dp)
    main_launches["eirate_classes"] = dp_runs["a"]["launches"]["eirate_classes"]

    observability = observability_phase(dev, counters, DevPlaneEngine,
                                        two_class_registry, stream, obs,
                                        ShardedScorer)
    emit(observability)

    suites = suites_phase(dev, counters)
    emit(suites)

    # launch (d)'s dry runs take the host's spare cores from here on: the
    # phases after the suites' timing bars hold nothing to a host clock
    dryrun_procs = _start_dryrun_cells()
    try:

        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(0)
        flash_cases = [flash_case(*c, gen, dev, flash_mod, ref) for c in FLASH_CASES]
        ssd_cases = [ssd_case(*c, gen, dev, ssd_mod, ref) for c in SSD_CASES]
        emit(dict(phase="kernels_data_plane",
                  tolerance_reason="the kernels sum in other orders than their "
                  "plain versions (full-matrix attention, the per-step SSD "
                  "recurrence); |got - want| <= rtol |want| + atol, atol a share "
                  "of max |want|: float32 output rtol 2e-4 and 2e-4 of max "
                  "|want|; bf16 output (both sides round a float32 result once, "
                  "at most one bf16 ulp apart) rtol 1e-2 and 1e-3 of max |want|. "
                  "The bf16 routes (flash: wgmma; SSD: tensor_cores) enter each "
                  "float32 factor of a product (flash's P; the SSD scan's W', "
                  "B' and carried state) as bf16 hi + lo, about 2^-17 a term, "
                  "and are held as well to their arithmetic step for step "
                  "(ref.attention_wgmma_route_ref, ref.ssd_chunked_ref) at the "
                  "same tolerance. The float32 routes (tf32x3) of both take each "
                  "float32 product as three TF32 products (tf32 hi + lo of each "
                  "factor, the lo x lo term dropped, about 2^-21 a term) and are "
                  "held as well to their arithmetic tile for tile "
                  "(ref.attention_tf32x3_route_ref, ref.ssd_tf32x3_route_ref) at "
                  "rtol 2e-5 and 2e-5 of max |want|: each pair differs only in "
                  "the order of sums and the exp (and the SSD scan's lcum, a warp "
                  "scan against torch.cumsum)",
                  flash_attention=flash_cases, ssd=ssd_cases,
                  phase_s=time.perf_counter() - t0))

        all_counters = {**counters, "flash_attention": (flash_mod, "launches"),
                        "ssd": (ssd_mod, "launches")}
        forward, served = {}, {}
        for arch in MODEL_ARCHS:
            params, cfg, forward[arch] = model_forward_phase(arch, 0, dev, all_counters)
            emit(forward[arch])
            served[arch] = serve_phase(arch, params, cfg, 0, dev, all_counters)
            emit(served[arch])
            del params
            torch.cuda.empty_cache()
        families, family_recs = model_families_phase(dev, all_counters)
        emit(families)
        emit(train_pieces_phase(dev))
        for arch in TRAIN_STEP_ARCHS:
            emit(train_step_phase(arch, dev, all_counters))
        service = service_phase(dev, all_counters)
        emit(service)
        emit(launch_phase(dev, all_counters, dryrun_procs))
    finally:
        for p in dryrun_procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    main_launches["flash_attention"] = forward["qwen3-4b"]["launches_per_forward"][
        "flash_attention"]
    main_launches["ssd"] = forward["mamba2-1.3b"]["launches_per_forward"]["ssd"]

    # Fig-5 shapes for the first two; the top-k kernel on the inputs the
    # churn trace's run (a) gave one shard, the class-axis kernel on inputs
    # devplane_churn's run (a) gave it; flash attention and the SSD scan on
    # layer 0's own inputs in model_forward (qwen3-4b, mamba2-1.3b)
    ro_fig5 = next(c for c in ro_cases if c["case"] == "k50_n50")
    head = {"eirate": ei_cases[0], "gp_readout": ro_fig5,
            "eirate_topk": rec["main_path_inputs"][0],
            "eirate_classes": dp["main_path_inputs"][0],
            "flash_attention": forward["qwen3-4b"]["layer0_kernel_case"],
            "ssd": forward["mamba2-1.3b"]["layer0_kernel_case"]}
    sources = {"eirate": ("src/repro_torch/kernels/csrc/ei_score.cu",
                          "src/repro/kernels/ei_score.py:185"),
               "gp_readout": ("src/repro_torch/kernels/csrc/gp_readout.cu",
                              "src/repro/kernels/gp_readout.py:85"),
               "eirate_topk": ("src/repro_torch/kernels/csrc/ei_topk.cu",
                               "src/repro/kernels/ei_score.py:235"),
               "eirate_classes": ("src/repro_torch/kernels/csrc/ei_classes.cu",
                                  "src/repro/kernels/ei_score.py:301"),
               # layer 0 is bf16: the wgmma route (float32: tf32x3, flash_attention.cu)
               "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
                                   "src/repro/kernels/flash_attention.py:118"),
               # layer 0 is bf16: the tensor-core route (float32: tf32x3, ssd.cu)
               "ssd": ("src/repro_torch/kernels/csrc/ssd_sm90.cu",
                       "src/repro/kernels/ssd.py:92")}
    # each kernel alone (device time under torch.profiler) beside its
    # wrapper's call; the top-k kernel's C launch; the routes
    extra = {name: dict(kernel_ms=head[name]["kernel_ms"]) for name in head}
    extra["eirate_topk"]["c_launch_ms"] = head["eirate_topk"]["c_launch_ms"]
    # the figures phase's launches (Fig. 2-5 at the full protocol)
    for name in ("eirate", "gp_readout"):
        extra[name]["figures_launches"] = figures["launches"][name]
    # the service's decisions (the example's protocol on the card)
    extra["gp_readout"]["service_launches"] = service["launches"]["gp_readout"]
    # the observability phase's (every plane on; kernels 1-4)
    for name, n in observability["launches"].items():
        extra[name]["observability_launches"] = n
    # the service suites' at full shapes (kernels 1-4)
    for name, n in suites["launches"].items():
        extra[name]["suites_launches"] = n
    for name in ("eirate", "eirate_topk", "eirate_classes"):
        # their "operations" floor is FP64: erf or erfc, and exp, in double,
        # as many as the inputs' terms execute
        extra[name]["fp64_instructions"] = head[name]["fp64_instructions"]
    # the readout at the Fig-5 shape beside the launch floor (an empty
    # kernel's device time); its paths
    extra["gp_readout"].update(
        launch_floor_ms=floor_ms, kernel_ms_above_floor=head["gp_readout"]["kernel_ms"] - floor_ms,
        paths={c["case"]: c["path"] for c in ro_cases})
    f32 = next(c for c in flash_cases if c["case"] == "qwen3_4b_f32")
    extra["flash_attention"].update(
        launches_by_route=forward["qwen3-4b"]["flash_launches_by_route"],
        routes={"wgmma": dict(dtype="bfloat16",
                              source="src/repro_torch/kernels/csrc/flash_attention_sm90.cu"),
                "tf32x3": dict(dtype="float32",
                               source="src/repro_torch/kernels/csrc/flash_attention.cu",
                               shape_of_times=f32["case"], ms=f32["ms"],
                               kernel_ms=f32["kernel_ms"], plain_ms=f32["plain_ms"],
                               library_ms=f32["library_ms"], bound_ms=f32["bound_ms"],
                               bound_by=f32["bound_by"],
                               bound_ms_f32_cuda_cores=f32["bound_ms_f32_cuda_cores"],
                               # serve's float32 decode-after-prefill check
                               serve_check_launches=served["qwen3-4b"][
                                   "decode_after_prefill"]["flash_launches_by_route"][
                                   "float32"]["tf32x3"])})
    s32 = next(c for c in ssd_cases if c["case"] == "mamba2_1p3b")
    serve_s32 = next(c for c in ssd_cases if c["case"] == "serve_check_f32")
    extra["ssd"].update(
        calls_by_route=forward["mamba2-1.3b"]["ssd_calls_by_route"],
        cuda_kernels_per_call=len(head["ssd"]["kernels"]),
        routes={"tensor_cores": dict(dtype="bfloat16",
                                     source="src/repro_torch/kernels/csrc/ssd_sm90.cu"),
                "tf32x3": dict(dtype="float32",
                               source="src/repro_torch/kernels/csrc/ssd.cu",
                               shape_of_times=s32["case"], ms=s32["ms"],
                               kernel_ms=s32["kernel_ms"],
                               kernel_ms_by_kernel=s32["kernel_ms_by_kernel"],
                               plain_ms=s32["plain_ms"], bound_ms=s32["bound_ms"],
                               bound_by=s32["bound_by"],
                               bound_ms_f32_cuda_cores=s32["bound_ms_f32_cuda_cores"],
                               serve_check_shape_kernel_ms=serve_s32["kernel_ms"],
                               # the float32 twin's calls and serve's float32
                               # decode-after-prefill check's
                               twin_calls=forward["mamba2-1.3b"]["cpu_twin"][
                                   "ssd_calls_by_route"]["tf32x3"],
                               serve_check_calls=served["mamba2-1.3b"][
                                   "decode_after_prefill"]["ssd_calls_by_route"][
                                   "float32"]["tf32x3"])})
    # the other families' forwards (model_families), and their kernels on
    # the inputs each model first gives them
    family_cases = {name: [m["layer0_kernel_cases"][name] for m in family_recs.values()
                           if name in m["layer0_kernel_cases"]]
                    for name in ("flash_attention", "ssd")}
    for name in family_cases:
        extra[name]["model_families_launches"] = {
            a: m["launches_per_forward"][name] for a, m in family_recs.items()
            if m["launches_per_forward"][name]}
    cases = {"eirate": ei_cases, "gp_readout": ro_cases,
             "eirate_topk": topk_cases + rec["main_path_inputs"],
             "eirate_classes": classes_cases + dp["main_path_inputs"],
             "flash_attention": flash_cases + [head["flash_attention"]]
             + family_cases["flash_attention"],
             "ssd": ssd_cases + [head["ssd"]] + family_cases["ssd"]}
    emit(dict(phase="profiler", windows_retried=PROFILER_RETRIES,
              attempts_allowed=PROFILER_ATTEMPTS))
    emit({"kernels": [dict(
        name=name, route="cuda", source=sources[name][0],
        replaces=sources[name][1], launches=main_launches[name],
        max_abs_err=max(c["max_abs_err"] for c in cases[name]),
        # each case's error as a share of its largest |plain value| (0 where
        # the kernel is held bit-equal)
        max_err_over_max_abs_want=max(c.get("err_over_max_abs_want", 0.0)
                                      for c in cases[name]),
        ms=head[name]["ms"], plain_ms=head[name]["plain_ms"],
        bound_ms=head[name]["bound_ms"], bound_by=head[name]["bound_by"],
        library_ms=head[name].get("library_ms"), shape_of_times=head[name]["case"],
        **extra.get(name, {}))
        for name in sources]})
    print(card_name_and_power(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
