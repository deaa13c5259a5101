"""Sharded scoring plane of the port, and index-space compaction.

  layout.py   RangeAllocator (slot reuse) + ShardLayout (blocks confined to
              shard spans); the port's copy of ``repro.shardgp.layout``
  compact.py  rebalance planner: relocate idle tenant blocks until shard
              loads sit within a bound; a copy of ``repro.shardgp.compact``
  score.py    ShardedScorer: per-shard EIrate (a CUDA kernel on the card),
              local top-k, one gather and the exact global pick

The control plane uses all three behind ``scorer="sharded"``
(``repro_torch.core.control_plane``).
"""

from .compact import DEFAULT_MAX_IMBALANCE, plan_moves  # noqa: F401
from .layout import BlockPlacement, RangeAllocator, ShardLayout  # noqa: F401
from .score import SCORE_KERNELS, SCORING_RULES, ShardedScorer  # noqa: F401
