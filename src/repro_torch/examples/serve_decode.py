"""Serving demo: prefill a batch of prompts, then decode tokens greedily.

The port's counterpart of the reference's ``examples/serve_decode.py``:
the same prefill/decode path that ``StaticBatchEngine`` serves (KV
ring-buffer caches, SSM state caches), on ``--device`` (default: the card;
``--device cpu`` runs it on the CPU, and without a card the default
raises).  A ``patches`` architecture (paligemma-3b) prefills its image
patches before the prompt's tokens; a ``frames`` one (musicgen-medium) is
refused, as in the reference.  ``--full`` takes the published widths
instead of the smoke config.  The cache holds the image's patches besides
the prompt and the new tokens (the reference's sizes it for the prompt and
the new tokens only, so its decode steps overwrite the oldest positions).

  PYTHONPATH=src python -m repro_torch.examples.serve_decode --arch paligemma-3b [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..device import resolve
from ..models import decode_step, init_params, prefill


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the smoke config)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    return ap.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Runs the demo; returns the prompts, the decoded tokens (B,
    new_tokens) and the prefill and decode seconds."""
    args = parse_args(argv)
    dev = resolve(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    if cfg.frontend == "frames":
        raise SystemExit("use a token-input arch for this demo")
    params = init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(0)

    prompts = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)).to(dev)}
    if cfg.frontend == "patches":
        prompts["patches"] = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.num_frontend_tokens, cfg.frontend_dim)).astype(np.float32)).to(dev)

    max_len = cfg.num_frontend_tokens + args.prompt_len + args.new_tokens + 8
    t0 = time.perf_counter()
    _, cache = prefill(params, prompts, cfg, max_len=max_len)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    print(f"prefill {args.batch}x{args.prompt_len}: {prefill_s:.2f}s")

    tok = prompts["tokens"][:, -1:]
    out = []
    t0 = time.perf_counter()
    for _ in range(args.new_tokens):
        logits, cache = decode_step(params, {"tokens": tok}, cache, cfg)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out.append(tok[:, 0])
    tokens = torch.stack(out, dim=1).cpu().numpy() if out else np.zeros((args.batch, 0))
    decode_s = time.perf_counter() - t0
    print(f"decoded {args.new_tokens} tokens/seq in {decode_s:.2f}s "
          f"({args.batch * args.new_tokens / decode_s:.1f} tok/s)")
    print("sample continuation (seq 0):", [int(t) for t in tokens[0, :16]])
    return dict(cfg=cfg, params=params, prompts=prompts, tokens=tokens,
                max_len=max_len, prefill_s=prefill_s, decode_s=decode_s)


if __name__ == "__main__":
    main()
