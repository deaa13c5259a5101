"""Compaction / rebalance planner for the sharded index space.

The port's own copy of ``repro.shardgp.compact``, the same logic.

Slot *reuse* (layout.RangeAllocator) already bounds memory; what it cannot
bound is *skew*: under heavy churn the live blocks can pile up in a few
shard spans while others sit empty, and the sharded scoring pass runs at
the speed of the fullest shard.  ``plan_moves`` restores the load-imbalance
bound by relocating whole tenant blocks from overloaded spans into free
ranges of underloaded ones.

The planner only *plans against the layout*; the caller
(``ControlPlane.compact``) owns moving the actual state (GP block indices,
membership columns, selected/observed/cost values) and reporting the old→new
id mapping to whoever holds global model ids (the streaming engine remaps
its launch queue and ownership maps).

Only blocks the caller marked movable are touched — the control plane
excludes tenants with in-flight trials, because an in-flight trial's global
model id is baked into its completion event.

Each applied move strictly lowers the donor span's load without raising any
span above it (sum-of-squares of span loads strictly decreases), so the loop
terminates; ``max_moves`` is a belt-and-braces cap, not the stop condition.
"""

from __future__ import annotations

from .layout import ShardLayout

DEFAULT_MAX_IMBALANCE = 1.25


def plan_moves(
    layout: ShardLayout,
    movable: set[int] | frozenset[int],
    max_imbalance: float = DEFAULT_MAX_IMBALANCE,
    max_moves: int | None = None,
) -> list[tuple[int, int, int]]:
    """Relocate movable blocks until ``layout.imbalance() <= max_imbalance``
    or no improving move exists.  Mutates the layout (placements + free
    ranges) and returns ``[(key, old_start, new_start), ...]`` in the order
    applied."""
    if max_imbalance < 1.0:
        raise ValueError(f"max_imbalance must be >= 1, got {max_imbalance}")
    moves: list[tuple[int, int, int]] = []
    cap = max_moves if max_moves is not None else 4 * max(len(layout.blocks), 1)
    while layout.imbalance() > max_imbalance and len(moves) < cap:
        counts = layout.live_counts()
        donor = max(range(layout.num_shards), key=lambda s: (counts[s], -s))
        cands = sorted(
            (k for k in movable if k in layout.blocks
             and layout.shard_of(layout.blocks[k].start) == donor),
            key=lambda k: (-layout.blocks[k].length, k))
        applied = False
        for k in cands:
            m = layout.blocks[k].length
            targets = sorted(
                (s for s in range(layout.num_shards) if s != donor),
                key=lambda s: (counts[s], s))
            for t in targets:
                if counts[t] + m >= counts[donor]:
                    continue    # move would not reduce the donor's lead
                lo, hi = layout.span(t)
                start = layout.alloc.alloc(m, lo, hi)
                if start is None:
                    continue
                old = layout.relocate(k, start)
                moves.append((k, old.start, start))
                applied = True
                break
            if applied:
                break
        if not applied:
            break
    return moves
