"""Deterministic, host-sharded synthetic data pipeline.

The port's copy of ``repro.data.pipeline``: numpy, the same generators and
the same keys, so every batch equals the reference's bit for bit.  It
serves every arch family (tokens / patches+tokens / frames) with:

  * deterministic generation keyed by (seed, host_id, step): a restarted or
    re-sharded job replays the exact stream (checkpoint/restart safety);
  * per-host sharding: each host draws only its slice of the global batch
    (host h owns rows [h*B/H, (h+1)*B/H));
  * background prefetch (double-buffered thread) to hide generation latency;
  * tenant-conditioned distributions (Zipf exponent per tenant) so the
    multi-tenant service's datasets genuinely differ.

Batches stay numpy arrays; the consumer moves them onto its device.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

from ..models.model import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3           # tenant-specific skew
    num_hosts: int = 1
    host_id: int = 0
    prefetch: int = 2

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global_batch {self.global_batch} is not a "
                             f"multiple of num_hosts {self.num_hosts}")
        return self.global_batch // self.num_hosts


class SyntheticLMStream:
    """Zipf-distributed token stream with a deterministic per-step RNG.

    ``model_cfg`` is read for ``frontend``, ``frontend_dim``,
    ``num_frontend_tokens``, ``num_lm_heads`` and ``vocab_size`` only."""

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig):
        self.cfg = cfg
        self.model_cfg = model_cfg

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed * 1_000_003 + self.cfg.host_id) * 1_000_003 + step)

    def batch_at(self, step: int) -> dict:
        c, m = self.cfg, self.model_cfg
        rng = self._rng(step)
        B, S = c.host_batch, c.seq_len

        def zipf_tokens(shape, vocab):
            # bounded Zipf via inverse-CDF on a truncated support
            ranks = np.arange(1, vocab + 1, dtype=np.float64)
            probs = ranks ** (-c.zipf_a)
            probs /= probs.sum()
            return rng.choice(vocab, size=shape, p=probs).astype(np.int32)

        if m.frontend == "patches":
            ni = m.num_frontend_tokens
            toks = zipf_tokens((B, S - ni), m.vocab_size)
            return {
                "patches": rng.standard_normal((B, ni, m.frontend_dim)).astype(np.float32),
                "tokens": toks,
                "labels": np.roll(toks, -1, axis=1),
            }
        if m.frontend == "frames":
            return {
                "frames": rng.standard_normal((B, S, m.frontend_dim)).astype(np.float32),
                "labels": zipf_tokens((B, S, m.num_lm_heads), m.vocab_size),
            }
        toks = zipf_tokens((B, S), m.vocab_size)
        return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def random_batch(model_cfg, B: int, S: int, rng: np.random.Generator) -> dict:
    """A batch of S positions as numpy arrays, drawn uniformly from ``rng``
    by the config's frontend: tokens and labels; ``patches``: the image's
    patches, then S - patches text tokens, labels over the text;
    ``frames``: frame embeddings and labels (B, S, heads).  The port's own
    (the reference has none): a batch for checks, where the stream's Zipf
    tokens and shifted labels matter not."""
    m, V = model_cfg, model_cfg.vocab_size
    if m.frontend == "frames":
        return {"frames": rng.standard_normal((B, S, m.frontend_dim)).astype(np.float32),
                "labels": rng.integers(0, V, (B, S, m.num_lm_heads)).astype(np.int32)}
    n = S - m.num_frontend_tokens if m.frontend == "patches" else S
    batch = {"tokens": rng.integers(0, V, (B, n)).astype(np.int32),
             "labels": rng.integers(0, V, (B, n)).astype(np.int32)}
    if m.frontend == "patches":
        batch["patches"] = rng.standard_normal(
            (B, m.num_frontend_tokens, m.frontend_dim)).astype(np.float32)
    return batch


def seq_key(batch: dict) -> str:
    """The batch's sequence input: ``frames`` or ``tokens``."""
    return "frames" if "frames" in batch else "tokens"


def split_last(batch: dict) -> tuple[dict, dict]:
    """(the batch less its last position and its labels, its last position
    alone): a prefill's input and the next decode step's.  An image's
    patches go with the prefill."""
    key = seq_key(batch)
    head = {k: (v[:, :-1] if k == key else v) for k, v in batch.items() if k != "labels"}
    return head, {key: batch[key][:, -1:]}


def make_batch_iterator(cfg: DataConfig, model_cfg: ModelConfig, start_step: int = 0):
    """Prefetching iterator of ``(step, batch)``; resume from ``start_step``
    after a restart.  ``close()`` stops its producer thread."""
    stream = SyntheticLMStream(cfg, model_cfg)
    q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set():
            try:
                q.put((step, stream.batch_at(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()
            t.join()

    return _Iter()
