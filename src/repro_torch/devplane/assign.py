"""Joint batched device<->model assignment (DESIGN.md §11); the port's copy
of ``repro.devplane.assign``.

When k devices free simultaneously (a completion wave, a join, t=0), the
sequential engine runs k scoring passes — GP readout + whole-pool EIrate +
argmax, once per device.  But between those k launches *nothing the scores
depend on changes* except the ``selected`` mask: no observation folds, no
incumbent moves.  So the k decisions are exactly a greedy assignment over a
single frozen (device-class x model) EIrate matrix — which one scoring pass
(``ControlPlane.choose_mdmt_batch``: per-class top-k, sharded or dense)
provides.

:func:`greedy_assign` is that solver, host-side over the (C, k) candidate
lists.  Order of assignment is by *score*, greedily: repeatedly give the
globally best (device, model) pair its launch, mask the model, repeat — a
1-item-per-round auction.  Tie-breaks are fully deterministic: higher score
first, then lower model id, then earlier device in launch-priority order.

Equivalence contract (tested): on a homogeneous fleet every device shares
one candidate row, so round r hands the r-th ranked candidate to the r-th
device in priority order — the *identical* trial sequence the sequential
per-device argmax produces.  On a heterogeneous fleet the greedy pick
maximizes EIrate jointly (a fast device outbids a slow one for the same
model), which sequential stack order cannot do.

Sufficiency of per-class top-k: a batch assigns at most k models, so at
most k-1 are masked before any device's last scan — a per-class list of
length k can never run dry while unselected models remain.
"""

from __future__ import annotations

import numpy as np

NEG_FLOOR = -1e29   # at/below this a candidate is unlaunchable (matches the
                    # sequential chooser's None cutoff in ControlPlane)


def greedy_assign(values, ids, device_class_rows) -> list[tuple[int, int]]:
    """Solve the k-device joint assignment over per-class top-k candidates.

    Args:
      values: (C, k) per-class candidate scores, descending (lowest-id ties
        first — ``ref.topk_first`` order).
      ids: (C, k) the candidates' global model ids.
      device_class_rows: length-k sequence; entry j is the class row (into
        ``values``/``ids``) of the j-th device in launch-priority order.

    Returns:
      ``[(device_pos, model_id), ...]`` in assignment (score) order;
      ``device_pos`` indexes ``device_class_rows``.  Devices whose class
      row runs out of launchable candidates are left out (the pool is
      exhausted for them, the sequential engine would have stopped too).
    """
    values = np.asarray(values)
    ids = np.asarray(ids)
    C, k = values.shape
    taken: set[int] = set()
    ptr = [0] * C                     # per-class scan position
    unassigned = list(range(len(device_class_rows)))
    out: list[tuple[int, int]] = []

    def head(c: int) -> tuple[float, int] | None:
        """First launchable candidate of class row c, skipping taken."""
        p = ptr[c]
        while p < k:
            v, g = float(values[c, p]), int(ids[c, p])
            if not np.isfinite(v) or v <= NEG_FLOOR:
                return None           # descending: the rest is worse
            if g not in taken:
                ptr[c] = p
                return v, g
            p += 1
        ptr[c] = p
        return None

    while unassigned:
        best = None                   # (-score, model_id, pos_rank, pos)
        for rank, pos in enumerate(unassigned):
            cand = head(device_class_rows[pos])
            if cand is None:
                continue
            key = (-cand[0], cand[1], rank)
            if best is None or key < best[0]:
                best = (key, pos, cand[1])
        if best is None:
            break                     # nobody has a launchable candidate
        _, pos, model = best
        taken.add(model)
        unassigned.remove(pos)
        out.append((pos, model))
    return out


__all__ = ["greedy_assign", "NEG_FLOOR"]
