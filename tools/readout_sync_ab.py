#!/usr/bin/env python3
"""A/B of where the sharded readout decision places its host inputs.

    python3 tools/readout_sync_ab.py [ROUNDS]

``ShardedScorer.readout_decide_topk`` places every input on its device
before its first launch, and alpha once a device.  An earlier order
uploaded the tenants' incumbents (``best``, a host array) after the
readout launches and alpha once a shard: a pageable upload waits for the
card, so that order waited once a shard and once more before scoring.
This script times both orders in one process, interleaved in ROUNDS
rounds (default 10) of 20 waited calls each, at the service suites'
shapes (|L| 100,000 at S 1 and 8; weak scaling's 25,000 and 200,000), on
``shard_scale``'s inputs, and checks that both pick the same model.

Prints one JSON line a shape (µs a decision each way, their ratio) and
the card's name and power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def waits_between(sc, W, alpha, mu0, kdiag, best, selected):
    """The earlier order: alpha uploaded by each shard's readout, ``best``
    and the rest after the readout launches."""
    from repro_torch.kernels import ops

    mu0s, kds = sc._per_shard(mu0), sc._per_shard(kdiag)
    posts = [ops.gp_readout(W[:, sc._span(s)].to(dev), alpha.to(dev),
                            mu0s[s], kds[s], emit_sd=True)
             for s, dev in enumerate(sc.mesh)]
    rest = sc._score_inputs(best, selected, 1.0)
    return sc._gather_pick(sc._score_phase(posts, *rest), sc.topk)


def main() -> int:
    import torch

    from repro_torch import _build
    from repro_torch.benchmarks.common import interleaved, time_us
    from repro_torch.benchmarks.shard_scale import _setup

    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    if not torch.cuda.is_available():
        print("readout_sync_ab: no CUDA device is available", file=sys.stderr)
        return 2
    _build.build()
    for n, s in ((100_000, 1), (100_000, 8), (25_000, 1), (200_000, 8)):
        sc, args = _setup(n, s, torch.device("cuda"))
        new_v, new_g = sc.readout_decide_topk(*args)
        old_v, old_g = waits_between(sc, *args)
        assert torch.equal(new_g, old_g) and torch.equal(new_v, old_v)
        us = interleaved({
            "placed_first": (lambda k: time_us(sc.readout_decide_topk, *args,
                                               iters=k, warmup=2, sync=True),
                             20 * rounds),
            "waits_between": (lambda k: time_us(waits_between, sc, *args,
                                                iters=k, warmup=2, sync=True),
                              20 * rounds)}, rounds=rounds)
        print(json.dumps(dict(live_models=n, shards=s, **us,
                              ratio=us["waits_between"] / us["placed_first"])),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
