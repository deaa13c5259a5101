"""End-to-end driver: train a ~100M-parameter dense LM for a few hundred steps.

Counterpart of the reference's ``examples/train_100m.py``, with its model,
its run and its options, plus ``--device`` (default: the card; ``cpu`` runs
the same path on the CPU): the synthetic Zipf data pipeline -> the
chunked-loss forward (the models' plain route, as the reference's) ->
AdamW -> async checkpointing every 100 steps, with resume support.

  PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 300] \\
      [--ckpt DIR] [--resume] [--device cpu]

:func:`train` is the loop, with the save interval as an argument.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.pipeline import DataConfig, make_batch_iterator
from repro_torch.device import resolve
from repro_torch.models import init_params
from repro_torch.models.model import ModelConfig
from repro_torch.models.spec import tree_leaves, tree_map
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.train.train_step import TrainState, make_train_step


def model_100m() -> ModelConfig:
    """~110M params: a 12L x 768 GQA decoder (GPT-2-small-ish, Qwen3 blocks)."""
    return ModelConfig(
        name="dense-100m", family="dense",
        num_layers=12, d_model=768, vocab_size=32000,
        num_heads=12, num_kv_heads=4, head_dim=64, qk_norm=True,
        d_ff=2048, tie_embeddings=True,
        q_chunk=128, xent_chunk=128,
    )


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def train(cfg: ModelConfig, *, steps: int = 300, batch: int = 4, seq: int = 128,
          ckpt: str, resume: bool = False,
          save_every: int = 100, device=None,
          params=None, stop_after: int | None = None, verbose: bool = True):
    """The reference example's run: AdamW (lr 6e-4, 30 warm-up steps, the
    cosine over ``steps``), ``CheckpointManager(keep=2)`` saving async
    every ``save_every`` steps and blocking at the end; ``resume`` restores
    the latest checkpoint and the data stream from its step.  ``params``
    (default: ``init_params(cfg, 0)``) are the initial parameters.
    ``stop_after`` ends the run after that step, as a crash would (no final
    save), for a later ``resume``.  Returns (the final state, the losses of
    the steps run, 0-d tensors)."""
    dev = resolve(device)
    if params is None:
        params = init_params(cfg, 0, device=dev)
    if verbose:
        n_params = sum(x.numel() for x in tree_leaves(params, _is_tensor))
        print(f"{cfg.name}: {n_params/1e6:.1f}M parameters")

    opt_cfg = OptConfig(lr=6e-4, warmup_steps=30, total_steps=steps)
    state = TrainState(params=params, opt=adamw_init(params, opt_cfg))
    mgr = CheckpointManager(ckpt, keep=2)
    start = 0
    if resume:
        restored = mgr.restore_latest(state)
        if restored:
            start, tree, _ = restored
            state = tree_map(lambda a: torch.from_numpy(a).to(dev), tree)
            if verbose:
                print(f"resumed from step {start}")

    step_fn = make_train_step(cfg, opt_cfg, None)
    it = make_batch_iterator(
        DataConfig(seq_len=seq, global_batch=batch, seed=0), cfg, start_step=start)

    t0, tok_per_step = time.time(), batch * seq
    losses = []
    for _ in range(steps - start):
        step, host = next(it)
        state, metrics = step_fn(state, {k: torch.from_numpy(v).to(dev)
                                         for k, v in host.items()})
        losses.append(metrics["loss"])
        if verbose and ((step + 1) % 25 == 0 or step == start):
            dt = time.time() - t0
            print(f"step {step+1:4d}  loss {float(metrics['loss']):.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"{tok_per_step*(step+1-start)/max(dt,1e-9):,.0f} tok/s")
        if (step + 1) % save_every == 0:
            mgr.save(step + 1, state, {"arch": cfg.name}, blocking=False)
        if stop_after is not None and step + 1 == stop_after:
            break
    it.close()
    if stop_after is None:
        mgr.save(steps, state, {"arch": cfg.name}, blocking=True)
    mgr.wait()
    if verbose:
        print("done; checkpoints in", ckpt)
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_100m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                 "train_100m_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    return train(model_100m(), steps=args.steps, batch=args.batch, seq=args.seq,
                 ckpt=args.ckpt, resume=args.resume, device=args.device)


if __name__ == "__main__":
    main()
