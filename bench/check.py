"""The comparison that decides ``correct`` for a sweep cell: each checked
episode of the program against the plain reference's run of the same
inputs (``reference.run_episode``).

Three numbers, each held to its own limit (``checks/<cell>.json``):

* ``trial_mismatches``: launches whose model, tenant hint, device, start
  or end differ from the reference's (launch order, times bit for bit);
* ``event_mismatches``: steps whose observed model or event time differ,
  plus a differing decision count or end time, one each;
* ``regret_err``: the largest gap between the program's regret curves and
  the reference's float64 ones, the instantaneous curve's over its value
  at t = 0 and the cumulative curve's over its final value.
"""

from __future__ import annotations

import numpy as np

from .reference import Episode

NAMES = ("trial_mismatches", "event_mismatches", "regret_err")
TRIAL_FIELDS = ("model", "user", "device", "start", "end")
#: the program's fill for trial slots an episode never launched
TRIAL_FILL = {"model": -1, "user": -2, "device": -1, "start": 0.0, "end": 0.0}


def episode_rows(result, i: int) -> dict:
    """Episode ``i`` of a program ``BatchResult``, as arrays of their own
    (copies: the call's logs can be freed)."""
    rows = {f: np.array(getattr(result, f"trial_{f}")[i]) for f in TRIAL_FIELDS}
    for f in ("obs_model", "obs_time", "inst_regret", "cum_regret",
              "decisions", "end_time"):
        rows[f] = np.array(getattr(result, f)[i])
    return rows


def compare(prog: dict, ref: Episode) -> dict:
    n = len(prog["model"])
    trial_bad = np.zeros(n, bool)
    for f in TRIAL_FIELDS:
        want = np.full(n, TRIAL_FILL[f], prog[f].dtype)
        got = getattr(ref, f"trial_{f}")[:n]
        want[:len(got)] = got
        trial_bad |= prog[f] != want
    event_bad = ((prog["obs_model"] != ref.obs_model) | (prog["obs_time"] != ref.obs_time)).sum()
    event_bad += int(prog["decisions"] != ref.decisions) + int(prog["end_time"] != ref.end_time)
    inst_err = np.abs(prog["inst_regret"] - ref.inst_regret).max() / max(ref.inst_regret[0], 1e-30)
    cum_err = np.abs(prog["cum_regret"] - ref.cum_regret).max() / max(np.abs(ref.cum_regret).max(), 1e-30)
    return {"trial_mismatches": int(trial_bad.sum()),
            "event_mismatches": int(event_bad),
            "regret_err": float(np.nan_to_num(max(inst_err, cum_err), nan=np.inf))}


def worst(readings: list[dict]) -> dict:
    """Each number's worst over the checked episodes (the counts summed)."""
    return {"trial_mismatches": sum(r["trial_mismatches"] for r in readings),
            "event_mismatches": sum(r["event_mismatches"] for r in readings),
            "regret_err": max(r["regret_err"] for r in readings)}
