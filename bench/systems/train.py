"""A training cell: one job training the configuration's model on one card
in a closed loop, each step through the port's own training step
(``repro_torch.train.make_train_step``: the model's loss on its plain
route, autograd with each block recomputed, clipping and AdamW).

A cell is a model (``configs/<name>.json``: its widths, precisions,
optimizer and initial distributions) under a job (``traffic/<name>.json``:
batch, sequence, the token law and the steps checked).  Set-up builds one
training state from the benchmark's weights (``train_inputs``), checks the
program's parameter tree against them, and drives that state through the
checked steps on rows 0, 1, ... (the first of them warms every shape up;
a traced run counts its aten operations); it keeps each checked step's
loss, the first gradient as AdamW took it and every leaf's change.  The
window runs further steps on further rows back to back while its elapsed
time is under ``seconds``, and ends at a step boundary; each step reads
back its loss and gradient norm.  A traced run then profiles further steps
until two traces agree (``devtrace.profile_agreed``, padded).  Once the
program's state is freed, the plain reference (``train_reference``) runs
the checked steps from the same weights and rows.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from pathlib import Path

import torch

from bench import devtrace, train_check, train_flops, train_inputs, train_reference

#: idle seconds at each end of a profiler window (``chip_smoke.PROFILER_PAD_S``)
PROFILER_PAD_S = 0.05
#: steps traced, at most, for two that agree: a traced step of ~100,000
#: device records loses one or two of them (inside the window) in about
#: half of its sessions
PROFILER_ATTEMPTS = 12
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(cfg: dict):
    """The program's ``ModelConfig`` for the configuration's widths and
    precisions."""
    from repro_torch.models.model import ModelConfig
    from repro_torch.models.ssm import SSMConfig

    w = train_inputs.widths(cfg)
    ssm = SSMConfig(d_model=w["d"], d_inner=w["di"], headdim=w["P"], d_state=w["N"],
                    conv_width=w["W"], chunk=w["Q"], dt_min=w["dt_min"], dt_max=w["dt_max"],
                    use_pallas=cfg["use_pallas"])
    return ModelConfig(name=cfg["name"], family="ssm", num_layers=w["L"], d_model=w["d"],
                       vocab_size=w["V_rows"], ssm=ssm, tie_embeddings=cfg["tie_embeddings"],
                       compute_dtype=DTYPES[cfg["compute_dtype"]],
                       param_dtype=DTYPES[cfg["param_dtype"]], remat=cfg["remat"],
                       use_pallas=cfg["use_pallas"])


def opt_config(cfg: dict):
    from repro_torch.train import OptConfig

    o = cfg["optimizer"]
    return OptConfig(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                     weight_decay=o["weight_decay"], clip_norm=o["clip_norm"],
                     warmup_steps=o["warmup_steps"], total_steps=o["total_steps"],
                     min_lr_ratio=o["min_lr_ratio"], moment_dtype=DTYPES[cfg["moment_dtype"]])


def leaf_norms(flat: dict[str, torch.Tensor]) -> dict[str, float]:
    """Each leaf's norm, one a layer for the stacked block leaves (the
    reference's leaves)."""
    out = {}
    for k, v in flat.items():
        if k.startswith("blocks."):
            norms = torch.linalg.vector_norm(v.float().flatten(1), dim=1).tolist()
            out.update({f"{k}.{i}": n for i, n in enumerate(norms)})
        else:
            out[k] = float(torch.linalg.vector_norm(v.float()))
    return out


class Job:
    """One training job: the program's step, its state and the next row."""

    def __init__(self, cell: dict, seed: int, device: torch.device, make_step):
        from repro_torch.models.model import model_specs
        from repro_torch.train import TrainState, adamw_init

        cfg = cell["config"]
        self.cfg, self.traffic, self.seed, self.device = cfg, cell["traffic"], seed, device
        mcfg, self.opt = model_config(cfg), opt_config(cfg)
        want = {k: tuple(s.shape) for k, s in train_inputs.flatten(model_specs(mcfg)).items()}
        flat = train_inputs.weights(cfg, seed, device, DTYPES[cfg["param_dtype"]])
        got = {k: tuple(v.shape) for k, v in flat.items()}
        if got != want:
            raise SystemExit(f"the program's parameter tree {want} is not the benchmark's {got}")
        params = train_inputs.nest(flat)
        self.state = TrainState(params=params, opt=adamw_init(params, self.opt))
        self.step_fn = make_step(mcfg, self.opt)
        self.row = 0

    def step(self) -> tuple[float, float]:
        """One step on the next row: (loss, gradient norm), read back."""
        batch = train_inputs.rows(self.cfg, self.traffic, self.seed, self.row, self.device)
        self.state, metrics = self.step_fn(self.state, batch)
        self.row += 1
        return float(metrics["loss"]), float(metrics["grad_norm"])


def checked_steps(job: Job, count: int, trace: bool = False) -> dict:
    """The job's first ``count`` steps, with the readings the comparison
    takes (``train_check.compare``); in a traced run the first step's aten
    operations, counted (``ops``, ``backward_ops``)."""
    losses, ops = [], {}
    for i in range(count):
        if trace and i == 0:
            (loss, _), ops["ops"], ops["backward_ops"] = devtrace.count_ops_with_backward(
                job.step, job.device.type)
        else:
            loss, _ = job.step()
        losses.append(loss)
        if i == 0:
            b1 = job.opt.b1
            grads = {k: n / (1 - b1)
                     for k, n in leaf_norms(train_inputs.flatten(job.state.opt["mu"])).items()}
    # the change from the weights as the program was given them
    start = train_inputs.weights(job.cfg, job.seed, job.device, DTYPES[job.cfg["param_dtype"]])
    now = train_inputs.flatten(job.state.params)
    changes = leaf_norms({k: now[k].float() - start.pop(k).float() for k in list(start)})
    return {"losses": losses, "grads": grads, "changes": changes, **ops}


def run(root: Path, cell: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, simulate, t_start: float) -> dict:
    """One run of a training cell: the readings the metric readers take.
    ``simulate`` makes the step from the model's and the optimizer's
    configurations (by default the program's ``make_train_step``)."""
    if simulate is None:
        from repro_torch.train import make_train_step as simulate

    def phase(name: str, since: float) -> float:
        now = time.perf_counter()
        print(f"phase {name} {now - since:.3f} s", file=sys.stderr, flush=True)
        return now

    cfg, traffic = cell["config"], cell["traffic"]
    cuda = device.type == "cuda"
    mark = phase("imports", t_start)
    job = Job(cell, seed, device, simulate)
    mark = phase("state", mark)
    prog = checked_steps(job, traffic["checked_steps"], trace)
    mark = phase("checked_steps", mark)
    if "ops" in prog:
        print(f"ops of a step {prog['ops']}, of them backward formulas {prog['backward_ops']}",
              file=sys.stderr, flush=True)
    setup_s = time.perf_counter() - t_start

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    steps = failed = 0
    t0 = time.perf_counter()
    while True:
        loss, gnorm = job.step()
        steps += 1
        failed += not (math.isfinite(loss) and math.isfinite(gnorm))
        t1 = time.perf_counter()
        if t1 - t0 >= seconds:
            break
    B, S = traffic["batch"], traffic["seq_len"]
    window = {"steps": steps, "tokens": steps * B * S, "elapsed_s": t1 - t0,
              "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None}
    mark = phase("window", t0)
    print(f"window {steps} steps, {window['elapsed_s']:.3f} s, last loss {loss}",
          file=sys.stderr, flush=True)

    prof = None
    if trace and cuda:
        _, prof, seen = devtrace.profile_agreed(job.step, PROFILER_ATTEMPTS, "train_step",
                                                PROFILER_PAD_S)
        mark = phase("profiled_steps", mark)
        print(f"trace {prof['kernels']} kernel records, {prof['launches']} launches; "
              f"device records of the traced steps {seen}", file=sys.stderr, flush=True)

    del job
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = train_reference.run(cfg, traffic, seed, device, traffic["checked_steps"])
    phase("reference", mark)
    backward_seen = prog.get("backward_ops", 0) > 0
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    return {"setup_s": setup_s, "window": window, "device_kind": kind,
            "compute_dtype": cfg["compute_dtype"], "flops_per_token": train_flops.per_token(cfg),
            "step_ops": prog.get("ops") if backward_seen else None, "profile": prof,
            "checks": train_check.compare(prog, ref),
            "checked": {"name": "steps_checked", "value": len(prog["losses"]),
                        "limit": traffic["checked_steps"]},
            "attempted": steps, "failed": failed}
