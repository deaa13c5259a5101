"""Meshes: the data plane's production and test meshes, and the scoring
mesh of the sharded GP-EI plane.

Counterpart of ``repro.launch.mesh``.  The production and test meshes are
named ``DeviceMesh``es built with ``init_device_mesh`` over whatever
process group is current: NCCL on cards, ``gloo`` or the threaded group in
tests, and the ``fake`` group of 256 or 512 ranks in the dry run
(``repro_torch.launch.dryrun``).  They are functions, so importing this
module touches no process group.

Production target: 16 x 16 = 256 cards ("data", "model"); the multi-pod
mesh stacks 2 of them (512) along a leading "pod" axis.

The scoring mesh: JAX runs the
sharded decision as one ``shard_map`` program over a 1-D ``("shard",)``
device mesh; the port keeps a single controller, and its mesh is a tuple of
``torch.device``s, one per shard (``repro_torch.shardgp.score``).
"""

from __future__ import annotations

import torch

from ..sharding.rules import mesh_context  # noqa: F401  (the reference's name)


def _device_type() -> str:
    """The mesh's device type: ``cuda`` on an NCCL group, else ``cpu``."""
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _make_mesh(shape, axes):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 ("data", "model"), or 2 x 16 x 16 ("pod", "data", "model"):
    the current process group must have 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes)


def make_test_mesh(data: int = 2, model: int = 2, pod: int | None = None):
    """A small mesh for tests, over a process group of data * model (*
    pod) ranks."""
    if pod:
        return _make_mesh((pod, data, model), ("pod", "data", "model"))
    return _make_mesh((data, model), ("data", "model"))


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
