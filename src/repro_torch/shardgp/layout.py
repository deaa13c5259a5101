"""Index-space layout for the sharded scoring plane (DESIGN.md §10).

The port's own copy of ``repro.shardgp.layout``, the same logic line for
line (the port imports nothing of the JAX package).  Two pieces, both
host-side bookkeeping:

* :class:`RangeAllocator` — a contiguous-range allocator over the model
  index space ``[0, capacity)`` with a coalescing free list.  This is what
  ends DESIGN.md §9's "append-only" index space: ``retire_tenant`` returns a
  block's slots here and the next ``add_tenant`` reuses them, so a
  long-running service's readout buffers stay O(live-model cap) instead of
  O(models ever admitted).

* :class:`ShardLayout` — partitions the index space into ``num_shards``
  contiguous spans of ``shard_capacity`` slots each (span ``s`` owns
  ``[s*C, (s+1)*C)``) and places every tenant block *entirely inside one
  span*, least-loaded span first.  The sharded scorer maps span ``s`` to
  mesh device ``s`` (the model axis split over the mesh), so block locality
  here is what makes a GP observation touch exactly one device's slice.

  Growth doubles ``shard_capacity``.  Because every new span boundary
  (multiple of ``2C``) is also an old boundary (multiple of ``C``), a block
  that never straddled an old boundary never straddles a new one — existing
  global ids stay valid across growth, only their span *assignment* shifts
  (which :meth:`ShardLayout.live_counts` recomputes from the block registry).

With ``num_shards=1`` the layout degenerates to a plain first-fit allocator,
so the single-device control plane runs the identical allocation policy —
the decision-equivalence contract between ``scorer="ops"`` and
``scorer="sharded"`` depends on both seeing the same index space.
"""

from __future__ import annotations

from dataclasses import dataclass


class RangeAllocator:
    """First-fit contiguous-range allocator with a coalescing free list.

    Deterministic: ``alloc`` always returns the lowest free address that
    fits, so identical churn sequences produce identical index spaces.
    """

    def __init__(self, capacity: int = 0):
        self.capacity = 0
        self._free: list[tuple[int, int]] = []   # sorted (start, length)
        if capacity:
            self.grow(capacity)

    def grow(self, new_capacity: int) -> None:
        """Extend the address space to ``new_capacity`` slots."""
        if new_capacity <= self.capacity:
            return
        self.free(self.capacity, new_capacity - self.capacity)
        self.capacity = new_capacity

    def alloc(self, m: int, lo: int = 0, hi: int | None = None) -> int | None:
        """Lowest free range of length ``m`` inside ``[lo, hi)``; None if no
        fit.  ``lo``/``hi`` let :class:`ShardLayout` confine a block to one
        shard span."""
        if m <= 0:
            raise ValueError(f"range length must be positive, got {m}")
        hi = self.capacity if hi is None else hi
        for i, (start, length) in enumerate(self._free):
            s = max(start, lo)
            if s + m <= min(start + length, hi):
                before = (start, s - start)
                after = (s + m, start + length - (s + m))
                repl = [r for r in (before, after) if r[1] > 0]
                self._free[i:i + 1] = repl
                return s
            if start >= hi:
                break
        return None

    def free(self, start: int, m: int) -> None:
        """Return ``[start, start+m)`` to the pool, coalescing neighbours."""
        if m <= 0:
            return
        import bisect
        i = bisect.bisect_left(self._free, (start, 0))
        if i > 0 and self._free[i - 1][0] + self._free[i - 1][1] > start:
            raise ValueError(f"double free at {start}")
        if i < len(self._free) and start + m > self._free[i][0]:
            raise ValueError(f"double free at {start}")
        self._free.insert(i, (start, m))
        # coalesce with left and right neighbours
        j = max(i - 1, 0)
        while j + 1 < len(self._free):
            s0, l0 = self._free[j]
            s1, l1 = self._free[j + 1]
            if s0 + l0 == s1:
                self._free[j:j + 2] = [(s0, l0 + l1)]
            elif s1 > start + m:
                break
            else:
                j += 1

    @property
    def free_slots(self) -> int:
        return sum(l for _, l in self._free)

    @property
    def live_slots(self) -> int:
        return self.capacity - self.free_slots


@dataclass(frozen=True)
class BlockPlacement:
    """Where a tenant block lives: global start slot + length."""
    start: int
    length: int

    @property
    def stop(self) -> int:
        return self.start + self.length


class ShardLayout:
    """Shard-span-confined block placement over a RangeAllocator (module
    docstring).  The unit of placement is a tenant block; the registry maps
    an opaque key (the ControlPlane tenant slot) to its placement."""

    def __init__(self, num_shards: int = 1, shard_capacity: int = 64):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = num_shards
        self.shard_capacity = max(1, shard_capacity)
        self.alloc = RangeAllocator(num_shards * self.shard_capacity)
        self.blocks: dict[int, BlockPlacement] = {}

    @property
    def capacity(self) -> int:
        return self.num_shards * self.shard_capacity

    def shard_of(self, slot: int) -> int:
        return slot // self.shard_capacity

    def span(self, shard: int) -> tuple[int, int]:
        return shard * self.shard_capacity, (shard + 1) * self.shard_capacity

    def live_counts(self) -> list[int]:
        """Live slots per shard span, recomputed from the block registry
        (span assignment shifts on growth)."""
        counts = [0] * self.num_shards
        for pl in self.blocks.values():
            counts[self.shard_of(pl.start)] += pl.length
        return counts

    def imbalance(self) -> float:
        """max/mean live load over shards (1.0 = perfectly balanced)."""
        counts = self.live_counts()
        total = sum(counts)
        if total == 0 or self.num_shards == 1:
            return 1.0
        return max(counts) / (total / self.num_shards)

    def occupancy(self) -> dict:
        """The capacity plane's structured view (obs/accounting.py): per-
        shard live slot counts plus the aggregate slot budget and the
        load-imbalance index, in one pass over the block registry."""
        counts = self.live_counts()
        live = sum(counts)
        return {
            "per_shard": counts,
            "num_shards": self.num_shards,
            "shard_capacity": self.shard_capacity,
            "slots_total": self.capacity,
            "slots_live": live,
            "slots_free": self.capacity - live,
            "blocks": len(self.blocks),
            "imbalance": self.imbalance(),
        }

    def _grow(self) -> None:
        self.shard_capacity *= 2
        self.alloc.grow(self.capacity)

    def place(self, key: int, m: int) -> int:
        """Place a block of ``m`` slots entirely inside one shard span,
        least-loaded span first (ties: lowest shard id).  Grows (doubling)
        until a span fits it.  Returns the global start slot."""
        if key in self.blocks:
            raise ValueError(f"block key {key} already placed")
        while True:
            counts = self.live_counts()
            order = sorted(range(self.num_shards), key=lambda s: (counts[s], s))
            for s in order:
                lo, hi = self.span(s)
                start = self.alloc.alloc(m, lo, hi)
                if start is not None:
                    self.blocks[key] = BlockPlacement(start, m)
                    return start
            self._grow()

    @classmethod
    def repartition(cls, blocks: dict[int, BlockPlacement],
                    num_shards: int) -> tuple["ShardLayout", dict[int, int]]:
        """Re-place an existing block registry onto a fresh ``num_shards``
        layout — the mesh shrink/regrow path (DESIGN.md §16).

        Blocks are placed in registry insertion order through the normal
        :meth:`place` policy (least-loaded span first, doubling growth), so
        the result is exactly the layout a restart on the new mesh would
        build by admitting the same tenants in the same order.  Returns the
        new layout plus the slot remap ``{old_global_slot: new_global_slot}``
        covering every slot of every block."""
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        lay = cls(num_shards=num_shards, shard_capacity=1)
        remap: dict[int, int] = {}
        for key, pl in blocks.items():
            start = lay.place(key, pl.length)
            for off in range(pl.length):
                remap[pl.start + off] = start + off
        return lay, remap

    def release(self, key: int) -> BlockPlacement:
        """Free a block's slots back to the allocator."""
        pl = self.blocks.pop(key)
        self.alloc.free(pl.start, pl.length)
        return pl

    def relocate(self, key: int, new_start: int) -> BlockPlacement:
        """Move a block to an already-allocated range at ``new_start``
        (the compaction planner allocates it; see compact.py)."""
        old = self.blocks[key]
        self.blocks[key] = BlockPlacement(new_start, old.length)
        self.alloc.free(old.start, old.length)
        return old
