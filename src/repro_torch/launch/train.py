"""End-to-end training launcher (data pipeline -> train step -> checkpoints).

Counterpart of ``repro.launch.train``, with its flags and its
fault-tolerance loop (async checkpointing, crash injection, resume), on one
card: ``--device`` (default the card; ``cpu`` runs the same path on the
CPU).  ``--smoke`` (the default) takes the architecture's reduced config,
``--full`` its published widths.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --smoke \\
      --device cpu --steps 50 --batch 8 --seq 128 --ckpt /tmp/ckpt [--resume]

A checkpoint holds the ``TrainState`` under the reference's flat names, so
the launcher also resumes from one that ``repro.launch.train`` wrote.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..data.pipeline import DataConfig, make_batch_iterator
from ..device import resolve
from ..models import init_params
from ..models.spec import tree_map
from ..train.optimizer import OptConfig, adamw_init
from ..train.train_step import TrainState, make_train_step

CRASH_EXIT_CODE = 17


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="olmo-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--crash-at-step", type=int, default=None,
                    help=f"fault-injection: exit with code {CRASH_EXIT_CODE} "
                         "after this step (tests)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    return ap.parse_args(argv)


def main(argv=None) -> TrainState:
    """Train as the flags say; returns the final state."""
    args = parse_args(argv)
    dev = resolve(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=min(10, args.steps // 5 + 1),
                        total_steps=args.steps)
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch, seed=args.seed)

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                         device=dev)
    state = TrainState(params=params, opt=adamw_init(params, opt_cfg))
    start_step = 0

    mgr = CheckpointManager(args.ckpt) if args.ckpt else None
    if mgr and args.resume:
        restored = mgr.restore_latest(state)
        if restored:
            start_step, tree, _ = restored
            state = tree_map(lambda a: torch.from_numpy(a).to(dev), tree)
            print(f"resumed from step {start_step}")

    step_fn = make_train_step(cfg, opt_cfg)
    it = make_batch_iterator(dcfg, cfg, start_step=start_step)

    t0 = time.time()
    for _ in range(args.steps - start_step):
        step, batch = next(it)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        state, metrics = step_fn(state, batch)
        if (step + 1) % 10 == 0 or step == start_step:
            print(f"step {step + 1:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.time() - t0):.1f}s)")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, state, {"arch": cfg.name}, blocking=False)
        if args.crash_at_step is not None and step + 1 == args.crash_at_step:
            print(f"injected crash at step {step + 1}")
            it.close()
            if mgr:
                mgr.wait()
            raise SystemExit(CRASH_EXIT_CODE)
    it.close()
    if mgr:
        mgr.save(args.steps, state, {"arch": cfg.name}, blocking=True)
    print("done")
    return state


if __name__ == "__main__":
    main()
