"""Roofline terms of a dry-run cell, from torch's own counters.

Counterpart of ``repro.launch.hlo_analysis``; the name is kept so a reader
finds it.  Where the reference reads XLA's compiled module (its cost
analysis and the collectives of its post-partitioning HLO), the port's dry
run (``repro_torch.launch.dryrun``) runs the cell eagerly on fake DTensors
and counts, below DTensor, on each rank's local shards:

  * flops, bytes and transcendentals of every aten op on local tensors
    (``LocalCounter`` in the dry run; bytes are each op's inputs and
    outputs, an unfused count: XLA's fusion would keep some of them on chip);
  * one record (op, result bytes, group size) per ``_c10d_functional``
    collective that DTensor issues (and its ``_dtensor.shard_dim_alltoall``), which :func:`parse_collectives` prices
    with the reference's ring model.

Hardware model: one NVIDIA H100 SXM, the constants of
``repro_torch.core.cost_model`` (989 TFLOP/s bf16, 3.35 TB/s HBM3,
450 GB/s NVLink a direction, 80 GB).

Terms (seconds, per training/serving step):
  compute    = flops_per_device / PEAK_FLOPS
  memory     = bytes_per_device / HBM_BW
  collective = wire_bytes_per_device / ICI_BW

``wire_bytes`` uses the standard ring model per op (e.g. all-reduce moves
2(g-1)/g x payload per device); ``payload_bytes`` (the sum of result
sizes) is recorded alongside.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field

from ..core.cost_model import HBM_BW, HBM_PER_CHIP, ICI_BW, PEAK_FLOPS  # noqa: F401

# _c10d_functional op name -> the reference's HLO collective name
COLLECTIVE_NAMES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
    "permute_tensor": "collective-permute",
}


@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=dict)        # op -> #occurrences
    payload_bytes: float = 0.0                        # sum of result sizes
    wire_bytes: float = 0.0                           # ring-model per-device bytes
    by_op_bytes: dict = field(default_factory=dict)   # op -> wire bytes


def parse_collectives(records, num_devices: int) -> CollectiveStats:
    """The ring model over ``records``: (op, result bytes, group size) per
    collective, ``op`` in the reference's names ("all-reduce", ...); a group
    size of None or 0 means the whole mesh."""
    stats = CollectiveStats()
    for op, result_bytes, group in records:
        g = max(group or num_devices, 1)
        if op == "all-reduce":
            wire = 2.0 * (g - 1) / g * result_bytes
        elif op == "all-gather":
            wire = (g - 1) / g * result_bytes
        elif op == "reduce-scatter":
            wire = (g - 1) * result_bytes       # operand is g x result
        elif op == "all-to-all":
            wire = (g - 1) / g * result_bytes
        else:                                   # collective-permute
            wire = result_bytes
        stats.counts[op] = stats.counts.get(op, 0) + 1
        stats.payload_bytes += result_bytes
        stats.wire_bytes += wire
        stats.by_op_bytes[op] = stats.by_op_bytes.get(op, 0.0) + wire
    return stats


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    num_devices: int
    flops_per_device: float
    bytes_per_device: float
    transcendentals: float
    collectives: dict
    collective_payload_bytes: float
    collective_wire_bytes: float
    compute_seconds: float
    memory_seconds: float
    collective_seconds: float
    dominant: str
    model_flops: float            # 6*N_active*D (train) / 2*N_active*D (serve)
    model_flops_global: float
    useful_flops_ratio: float     # model_flops_global / (flops_per_device * chips)
    memory_stats: dict
    fits_hbm: bool

    def to_dict(self):
        return asdict(self)


def analyze(counts: dict, *, arch: str, shape: str, mesh_name: str,
            num_devices: int, model_flops_global: float) -> Roofline:
    """The roofline of one counted cell (the counterpart of
    ``analyze_compiled``).  ``counts`` holds one rank's ``flops``,
    ``bytes``, ``transcendentals``, collective ``records`` and
    ``memory_stats`` (``argument_bytes``, ``output_bytes``, ``temp_bytes``,
    ``alias_bytes``, ``peak_bytes``)."""
    flops = float(counts["flops"])
    byts = float(counts["bytes"])
    colls = parse_collectives(counts["records"], num_devices)
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    coll_s = colls.wire_bytes / ICI_BW
    dominant = max(
        (("compute", compute_s), ("memory", memory_s), ("collective", coll_s)),
        key=lambda kv: kv[1])[0]
    mem_stats = dict(counts["memory_stats"])
    hlo_global = flops * num_devices
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, num_devices=num_devices,
        flops_per_device=flops, bytes_per_device=byts,
        transcendentals=float(counts["transcendentals"]),
        collectives=colls.counts,
        collective_payload_bytes=colls.payload_bytes,
        collective_wire_bytes=colls.wire_bytes,
        compute_seconds=compute_s, memory_seconds=memory_s,
        collective_seconds=coll_s, dominant=dominant,
        model_flops=model_flops_global / max(num_devices, 1),
        model_flops_global=model_flops_global,
        useful_flops_ratio=(model_flops_global / hlo_global) if hlo_global else 0.0,
        memory_stats=mem_stats,
        fits_hbm=bool(mem_stats["peak_bytes"] <= HBM_PER_CHIP),
    )


def model_flops_for_cell(cfg, shape_name: str) -> float:
    """6*N_active*D for training, 2*N_active*D for serving (forward-only)."""
    from ..configs import SHAPES
    S, B, kind = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n_active * S * B
    if kind == "prefill":
        return 2.0 * n_active * S * B
    # decode: one token per sequence
    return 2.0 * n_active * B
