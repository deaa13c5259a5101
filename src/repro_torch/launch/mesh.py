"""The scoring mesh of the sharded GP-EI plane.

Counterpart of ``repro.launch.mesh.make_scoring_mesh``.  JAX runs the
sharded decision as one ``shard_map`` program over a 1-D ``("shard",)``
device mesh; the port keeps a single controller, and its mesh is a tuple of
``torch.device``s, one per shard (``repro_torch.shardgp.score``).  Only the
scoring mesh is ported: the production and test meshes belong to the data
plane.
"""

from __future__ import annotations

import torch


def make_scoring_mesh(num_shards: int | None = None,
                      device=None) -> tuple[torch.device, ...]:
    """One device per shard of the model axis.

    ``device=None`` spreads the shards over distinct visible CUDA cards,
    shard ``s`` on ``cuda:s``, every card by default, and raises when there
    are fewer cards than shards.  An explicit ``device`` puts every shard on
    that one device (one shard by default): the port's counterpart of the
    reference's forced host devices, which the CPU tests (``device="cpu"``)
    and a one-card run use to drive several logical shards.  The decision
    is exact for any shard count, so the mesh is a capacity knob, not a
    correctness one."""
    if num_shards is not None and num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if device is not None:
        return (torch.device(device),) * (num_shards or 1)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to put every "
            "shard on the CPU")
    n = count if num_shards is None else num_shards
    if n > count:
        raise ValueError(f"num_shards must be in [1, {count}] with one card "
                         f"per shard, got {n}; pass device= to put several "
                         f"shards on one device")
    return tuple(torch.device("cuda", i) for i in range(n))
