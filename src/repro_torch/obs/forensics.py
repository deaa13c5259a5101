"""Per-decision forensics: WHY did GP-EI pick this (model, tenant) pair?

The port's copy of ``repro.obs.forensics`` (pure Python, as the reference's):
the same names, records and JSON, so the two packages' outputs compare
field by field.

The decision path reduces the whole live pool to one argmax and throws the
rest away; when a tenant asks "why is my trial not running", the operator
has nothing.  :class:`ForensicsRecorder` captures, for every policy
decision, the attribution the scoring program already materializes
(DESIGN.md §14):

* the winner and runner-up with their EIrate scores and the argmax
  *margin* between them;
* the μ/σ/cost decomposition of each top-k candidate (EIrate = EI/cost,
  so EI recovers as ``score × effective_cost`` — no extra scoring pass);
* a uniform-cost counterfactual: who would win if every trial cost the
  same — i.e. is this pick EI-driven or cheapness-driven?  (For the
  sharded scorer the counterfactual argmax is taken *within* the
  materialized top-k — exact whenever the uniform-cost winner's EIrate
  also reaches the top-k, which is the overwhelmingly common case; the
  fused path scores the full pool so its counterfactual is exact.)

Recording is observation-only: the engines' decision path is unchanged
(the sharded ``decide()`` is literally the head of ``decide_topk()``, so
forensics just keeps the k values the decision already computed), records
never enter engine snapshots, and every field is derived from sim-time/
decision state — a crash-recovered run re-emits byte-identical records
for its replayed suffix (tests/test_eventlog.py).  Records are keyed by
``(event_index, seq)`` — ``seq`` separates the multiple per-class
decisions of one batched devplane wave.
"""

from __future__ import annotations

import json
import math

FORENSICS_SCHEMA_VERSION = 1


def _f(v) -> float | None:
    """JSON-safe float: allow_nan=False streams reject inf/nan."""
    v = float(v)
    return v if math.isfinite(v) else None


class ForensicsRecorder:
    """Append-only per-decision attribution stream.

    Hand to ``StreamEngine(forensics=...)``; the engine threads it into
    ``ControlPlane.set_forensics`` and calls :meth:`begin_event` once per
    processed event so records carry (event_index, seq) keys.  With
    ``path`` set, records stream write-through to JSONL.
    """

    def __init__(self, path: str | None = None):
        self.records: list[dict] = []
        self._fh = open(path, "a", encoding="utf-8") if path else None
        self._t = 0.0
        self._event_index = -1
        self._seq = 0

    def begin_event(self, t: float, event_index: int) -> None:
        self._t = float(t)
        self._event_index = int(event_index)
        self._seq = 0

    def _candidate(self, model: int, score: float, eff_cost: float,
                   mu: float | None, sd: float | None) -> dict:
        ei = score * eff_cost if math.isfinite(score) else float("-inf")
        return {"model": int(model), "eirate": _f(score), "ei": _f(ei),
                "mu": _f(mu) if mu is not None else None,
                "sd": _f(sd) if sd is not None else None,
                "cost": _f(eff_cost)}

    def on_decision(self, *, scorer: str, values, gids, eff_costs,
                    mu=None, sd=None, speed: float = 1.0,
                    device_class: str | None = None) -> dict:
        """Record one scoring decision from its materialized top-k.

        ``values``/``gids``/``eff_costs`` are aligned (k,) sequences of
        EIrate scores, global model ids, and the *effective* per-candidate
        costs the scores were divided by (cost/speed, or the class's
        affine cost row).  ``mu``/``sd`` are optional aligned posterior
        slices for the decomposition.
        """
        cands = []
        for j in range(len(values)):
            v = float(values[j])
            if not math.isfinite(v) or v <= -1e29:
                break           # padded / inert tail of the top-k
            cands.append(self._candidate(
                int(gids[j]), v, float(eff_costs[j]),
                None if mu is None else float(mu[j]),
                None if sd is None else float(sd[j])))
        winner = cands[0] if cands else None
        runner = cands[1] if len(cands) > 1 else None
        margin = (winner["eirate"] - runner["eirate"]
                  if winner and runner and winner["eirate"] is not None
                  and runner["eirate"] is not None else None)
        # uniform-cost counterfactual: argmax of EI alone over the top-k
        # (ties to the lowest model id, matching the decision tie-break)
        cf = None
        if cands:
            best = max(c["ei"] for c in cands if c["ei"] is not None)
            cf_model = min(c["model"] for c in cands if c["ei"] == best)
            cf = {"model": cf_model,
                  "changes_pick": bool(cf_model != winner["model"])}
        rec = {"schema_version": FORENSICS_SCHEMA_VERSION,
               "t": self._t, "event_index": self._event_index,
               "seq": self._seq, "scorer": scorer, "speed": _f(speed),
               "device_class": device_class,
               "winner": winner, "runner_up": runner, "margin": _f(margin)
               if margin is not None else None,
               "uniform_cost": cf, "topk": cands}
        self._seq += 1
        self.records.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec, allow_nan=False) + "\n")
            self._fh.flush()
        return rec

    def on_incident(self, *, kind: str, **detail) -> dict:
        """Record one failure-domain incident (DESIGN.md §16): a trial
        timeout, a poisoned observation, a device quarantine, a mesh
        shrink.  Incident records share the decision stream (and its
        (event_index, seq) keying) but carry ``"record": "incident"`` so
        report tooling can split them; every float is sanitized for the
        allow_nan=False stream."""
        clean = {k: (_f(v) if isinstance(v, float) else v)
                 for k, v in detail.items()}
        rec = {"schema_version": FORENSICS_SCHEMA_VERSION,
               "record": "incident",
               "t": self._t, "event_index": self._event_index,
               "seq": self._seq, "kind": kind, "detail": clean}
        self._seq += 1
        self.records.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec, allow_nan=False) + "\n")
            self._fh.flush()
        return rec

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


__all__ = ["ForensicsRecorder", "FORENSICS_SCHEMA_VERSION"]
