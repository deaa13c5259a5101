"""Batched serving engine over the prefill/decode substrate.

Counterpart of ``repro.serve.engine``.  Wave-based static batching:
requests are grouped into waves of ``batch_slots``, left-padded to a
common prompt length, prefilled once, then decoded lock-step (greedy
argmax) with per-request stopping.  Finished requests exit the wave; the
engine counts decode steps and slot steps, so the multi-tenant service can
cost serving trials the way it costs training trials.  The reference's
``jax.jit`` of the decode step is a plain call here.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve
from ..models.model import ModelConfig, decode_step, prefill
from ..models.spec import tree_leaves


@dataclass
class Request:
    request_id: int
    tokens: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int = 32
    eos_id: int | None = None
    output: list[int] = field(default_factory=list)
    done: bool = False


@dataclass
class ServeConfig:
    batch_slots: int = 4
    max_len: int = 512
    pad_id: int = 0


class StaticBatchEngine:
    """Serves requests with ``params`` on ``device`` (None: the card, and
    an error without one).  ``stats`` counts waves, decode steps and slot
    steps, and the seconds of the whole waves (``wall``), of prefill and of
    the decode steps (each ending in a device synchronize)."""

    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig | None = None,
                 *, device=None):
        self.device = dev = resolve(device)
        for t in tree_leaves(params, lambda x: isinstance(x, torch.Tensor)):
            if t.device.type != dev.type or dev.index not in (None, t.device.index):
                raise ValueError(f"a parameter is on {t.device}, the engine runs "
                                 f"on {dev}")
        self.cfg = cfg
        self.params = params
        self.serve = serve_cfg or ServeConfig()
        self.queue: list[Request] = []
        self.stats = {"waves": 0, "decode_steps": 0, "slot_steps_used": 0,
                      "slot_steps_total": 0, "wall": 0.0, "prefill": 0.0,
                      "decode": 0.0}

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _next_wave(self) -> list[Request]:
        wave, self.queue = (self.queue[: self.serve.batch_slots],
                            self.queue[self.serve.batch_slots:])
        return wave

    def run(self) -> list[Request]:
        done: list[Request] = []
        while self.queue:
            done.extend(self._run_wave(self._next_wave()))
        return done

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_wave(self, wave: list[Request]) -> list[Request]:
        t0 = time.perf_counter()
        B = len(wave)
        plen = max(len(r.tokens) for r in wave)
        toks = np.full((B, plen), self.serve.pad_id, np.int32)
        for i, r in enumerate(wave):
            toks[i, plen - len(r.tokens):] = r.tokens   # left-pad
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        max_new = max(r.max_new_tokens for r in wave)
        _, cache = prefill(self.params, batch, self.cfg,
                           max_len=min(plen + max_new + 8, self.serve.max_len))
        self._sync()
        t1 = time.perf_counter()
        self.stats["prefill"] += t1 - t0

        last = batch["tokens"][:, -1:]
        active = np.ones(B, bool)
        for _ in range(max_new):
            logits, cache = decode_step(self.params, {"tokens": last}, cache, self.cfg)
            nxt_t = torch.argmax(logits[:, -1], dim=-1)
            nxt = nxt_t.cpu().numpy().astype(np.int32)
            self.stats["decode_steps"] += 1
            self.stats["slot_steps_total"] += B
            self.stats["slot_steps_used"] += int(active.sum())
            for i, r in enumerate(wave):
                if not active[i]:
                    continue
                r.output.append(int(nxt[i]))
                if (r.eos_id is not None and nxt[i] == r.eos_id) or \
                        len(r.output) >= r.max_new_tokens:
                    r.done = True
                    active[i] = False
            if not active.any():
                break
            last = nxt_t[:, None].to(torch.int32)
        for r in wave:
            r.done = True
        self.stats["waves"] += 1
        now = time.perf_counter()
        self.stats["decode"] += now - t1
        self.stats["wall"] += now - t0
        return wave

    @property
    def slot_utilization(self) -> float:
        tot = self.stats["slot_steps_total"]
        return self.stats["slot_steps_used"] / tot if tot else 1.0
