"""The plain reference against the program: at a tiny size on the CPU,
``reference.run_episode`` gives the trial sequences, event records and
decision counts of ``simulate_batch(device="cpu")`` exactly and its regret
curves to float32 rounding, for all three policies on both deployments;
the bfloat16 control does not.  The last test holds the program on the
card to the same reference (marked ``cuda``; it skips without a card).
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

from bench import check, reference  # noqa: E402
from bench.generators import ease_ml_zoo, matern_blocks  # noqa: E402

FIG5 = {"num_users": 4, "num_models_per_user": 5, "length_scale": 0.2,
        "kernel_variance": 0.04, "cost": "uniform"}
ZOO = {"models": list("abcdefgh"), "num_prior_users": 8, "num_test_users": 4,
       "acc_std": 0.04, "base_accuracy": [0.6, 0.92], "cost_range": [600.0, 21600.0],
       "size_factor": [0.5, 2.0], "clip": [0.02, 0.995]}
LIMITS = {"trial_mismatches": 0, "event_mismatches": 0, "regret_err": 1e-6}


def _batch(gen, cfg, seed, device):
    from repro_torch.core.sim_batched import EpisodeSpec, simulate_batch
    from repro_torch.core.tenancy import Problem

    inputs = gen.build(cfg, seed)
    truth = gen.draw_truth(cfg, inputs, 3, seed, "cpu")
    specs = [EpisodeSpec(p, M, seed=seed + 7 * k + M, z_true=truth[k])
             for p in ("mdmt", "round_robin", "random") for M in (1, 3) for k in range(3)]
    # B 18: the issue's B 8 and more, all three policies, two device counts
    problem = Problem(K=inputs["K"], mu0=inputs["mu0"], z_true=inputs["z_true"],
                      cost=inputs["cost"], membership=inputs["membership"])
    return inputs, specs, simulate_batch(problem, specs, 2, 1e-6, device=device)


def _readings(inputs, specs, result, precision="float32"):
    T = result.obs_model.shape[1]
    return [check.compare(check.episode_rows(result, i),
                          reference.run_episode(inputs, s.policy, s.num_devices, s.seed,
                                                s.z_true, 2, 1e-6, T, precision))
            for i, s in enumerate(specs)]


@pytest.mark.parametrize("gen,cfg", [(matern_blocks, FIG5), (ease_ml_zoo, ZOO)],
                         ids=["fig5", "zoo"])
@pytest.mark.parametrize("seed", [0, 2_147_483_659])
def test_reference_equals_program_on_cpu(gen, cfg, seed):
    inputs, specs, result = _batch(gen, cfg, seed, "cpu")
    for r in _readings(inputs, specs, result):
        assert all(r[k] <= LIMITS[k] for k in check.NAMES), r


@pytest.mark.parametrize("gen,cfg", [(matern_blocks, {**FIG5, "num_users": 8, "num_models_per_user": 10}),
                                     (ease_ml_zoo, ZOO)], ids=["fig5", "zoo"])
def test_bfloat16_control_departs(gen, cfg):
    inputs, specs, result = _batch(gen, cfg, 5, "cpu")
    T = result.obs_model.shape[1]
    ctrl = [reference.run_episode(inputs, s.policy, s.num_devices, s.seed, s.z_true,
                                  2, 1e-6, T, "bfloat16") for s in specs]
    assert sum((c.trial_model != result.trial_model[i]).any() for i, c in enumerate(ctrl)) >= len(specs) // 3


def test_threefry_known_answer():
    # Threefry-2x32, 20 rounds: the known-answer vector of Salmon et al.
    # (key and counter all ones), as JAX's tests hold it
    from bench import threefry
    x = threefry.threefry2x32(0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF)
    assert x == (0x1CB996FC, 0xBB002BE7)


@pytest.mark.cuda
def test_program_on_card_equals_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for gen, cfg in ((matern_blocks, FIG5), (ease_ml_zoo, ZOO)):
        inputs, specs, result = _batch(gen, cfg, 11, "cuda")
        for r in _readings(inputs, specs, result):
            assert all(r[k] <= LIMITS[k] for k in check.NAMES), r
