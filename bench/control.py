"""The control of a cell's comparison, and its faults, dispatched by the
cell's system.

    python3 bench/control.py --workload <cell> --seeds <n>[,<n>...] [--variants <v>,...]

A sweep cell: the reference in bfloat16 put in the program's place, judged
by the comparison that decides ``correct``.  It draws a run's inputs
exactly as ``bench/run.py`` does for each seed (the ground truths on the
card when there is one), takes the episodes a run checks, and prints one
JSON line a seed with the numbers the control reads (``check.NAMES``); it
imports nothing of the program.

A training cell: the program's own lower-precision path, parameters and
AdamW moments in bfloat16 (``control``), beside the sound program
(``program``) and the faults of ``train_faults`` named in ``--variants``;
each runs the checked steps of a run on the seed's inputs, and one line a
seed gives each variant's numbers (``train_check.NAMES``) against one run
of the reference.

Their readings are the ends the limits in ``checks/<cell>.json`` were set
between; the benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def readings(root: Path, cell: dict, seed: int, device, precision: str = "bfloat16") -> dict:
    from bench import check, reference
    from bench.systems import sweep

    cfg, traffic = cell["config"], cell["traffic"]
    gen = sweep.generator(root, cfg)
    inputs = gen.build(cfg, seed)
    truth = gen.draw_truth(cfg, inputs, traffic["draws"], seed, device)
    layout = sweep.episodes(traffic, seed)
    T = inputs["membership"].shape[1] + max(traffic["device_counts"])
    picked = sweep.checked_episodes(len(layout), traffic["check_episodes"], seed)
    jobs = sweep.reference_jobs(cfg, layout, truth, picked, T)
    workers = min(sweep.REFERENCE_WORKERS, len(jobs))
    refs = reference.run_many(inputs, jobs, workers)
    ctrl = reference.run_many(inputs, [(*j, precision) for j in jobs], workers)
    return check.worst([check.compare(as_rows(c), r) for c, r in zip(ctrl, refs)])


def train_readings(root: Path, cell: dict, seed: int, device, variants) -> dict:
    """Each variant's numbers against one reference run of the seed."""
    import gc

    import torch

    sys.path.insert(0, str(root / "src"))

    from bench import train_check, train_faults, train_reference
    from bench.systems import train
    from repro_torch.train import make_train_step

    unknown = set(variants) - {"program", "control", *train_faults.FAULTS}
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    steps = cell["traffic"]["checked_steps"]
    progs = {}
    for name in variants:
        c, make = cell, train_faults.FAULTS.get(name, make_train_step)
        if name == "control":
            c = dict(cell, config=dict(cell["config"], param_dtype="bfloat16",
                                       moment_dtype="bfloat16"))
        job = train.Job(c, seed, device, make)
        progs[name] = train.checked_steps(job, steps)
        del job
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    ref = train_reference.run(cell["config"], cell["traffic"], seed, device, steps)
    return {name: {**train_check.compare(p, ref), "worst": train_check.worst_leaves(p, ref)}
            for name, p in progs.items()}


def as_rows(ep) -> dict:
    """A reference episode in the layout ``check.episode_rows`` gives the
    program's (float32 regret curves, trial slots padded as the program
    pads them)."""
    from bench import check

    n = len(ep.trial_model)
    rows = {f: np.asarray(getattr(ep, f"trial_{f}")) for f in check.TRIAL_FIELDS}
    rows = {f: np.r_[v, np.full(n - len(v), check.TRIAL_FILL[f], v.dtype)] for f, v in rows.items()}
    rows.update(obs_model=ep.obs_model, obs_time=ep.obs_time,
                inst_regret=ep.inst_regret.astype(np.float32),
                cum_regret=ep.cum_regret.astype(np.float32),
                decisions=ep.decisions, end_time=np.float32(ep.end_time))
    return rows


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    from bench import run

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="control",
                   help="a training cell's: control, program and train_faults.FAULTS' names")
    args = p.parse_args(argv)
    cell = run.load_cell(ROOT, args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        line = {"workload": args.workload, "seed": seed, "device": device.type}
        if cell["config"]["system"] == "train":
            line["readings"] = train_readings(ROOT, cell, seed, device, args.variants.split(","))
        else:
            line["control"] = readings(ROOT, cell, seed, device)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
