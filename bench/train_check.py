"""The comparison that decides ``correct`` for a training cell: the
program's first steps against the plain reference's (``train_reference``)
on the same weights and rows.

Three numbers, each held to its own limit (``checks/<cell>.json``):

* ``loss_rel_err``: the largest relative gap of a checked step's loss;
* ``grad_norm_rel_err``: the first gradient as AdamW took it (read back
  from the program's first moment after one step, over 1 - b1), by leaf:
  the worst gap between the program's norm of a leaf and the reference's,
  over the reference's norm of that leaf or of the median leaf, whichever
  is larger;
* ``update_err``: the same gap for each leaf's change over the checked
  steps, leaving out the leaves whose reference gradient is under
  ``NEGLIGIBLE`` of the median leaf's (they move by round-off alone).

A leaf is one layer's slice of a stacked block leaf, or a leaf of its own.
"""

from __future__ import annotations

import math
import statistics

NAMES = ("loss_rel_err", "grad_norm_rel_err", "update_err")
NEGLIGIBLE = 1e-3


def _worst(prog: dict, ref: dict, keys) -> tuple[float, str | None]:
    """The largest gap of the leaves ``keys`` and the leaf that has it."""
    keys = list(keys)
    if not keys or set(keys) - set(prog):
        return math.inf, None
    floor = statistics.median(ref.values())
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], floor) for k in keys}
    leaf = max(gaps, key=lambda k: math.inf if math.isnan(gaps[k]) else gaps[k])
    return (math.inf if math.isnan(gaps[leaf]) else gaps[leaf]), leaf


def _moved(ref: dict) -> list[str]:
    floor = statistics.median(ref["grads"].values())
    return [k for k, g in ref["grads"].items() if g >= NEGLIGIBLE * floor]


def compare(prog: dict, ref: dict) -> dict:
    """The three numbers of one run: ``prog`` and ``ref`` each hold
    ``losses`` (a step's loss, in order), ``grads`` and ``changes`` (a
    leaf's norm by name)."""
    if len(prog["losses"]) != len(ref["losses"]):
        loss = math.inf
    else:
        loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    return {"loss_rel_err": math.inf if math.isnan(loss) else loss,
            "grad_norm_rel_err": _worst(prog["grads"], ref["grads"], ref["grads"])[0],
            "update_err": _worst(prog["changes"], ref["changes"], _moved(ref))[0]}


def worst_leaves(prog: dict, ref: dict) -> dict:
    """The leaf that sets each leaf-wise number, with the program's and the
    reference's norms of it, and how many leaves the update leaves out."""
    out = {"left_out": len(ref["grads"]) - len(_moved(ref))}
    for k, keys in (("grads", ref["grads"]), ("changes", _moved(ref))):
        leaf = _worst(prog[k], ref[k], keys)[1]
        out[k] = [leaf, prog[k].get(leaf), ref[k].get(leaf)]
    return out
