"""Multi-pod dry run: stage every (architecture x input-shape x mesh) cell on
the production meshes without a card, and count its roofline terms.

Counterpart of ``repro.launch.dryrun``, with its CLI:

  single pod : 16 x 16 = 256 ranks, axes ("data", "model")
  multi pod  : 2 x 16 x 16 = 512 ranks, axes ("pod", "data", "model")

Where the reference compiles each cell for 256 or 512 placeholder XLA
devices, the port runs it eagerly as rank 0 of the ``fake`` process group
(``torch.testing._internal.distributed.fake_pg``) at world size 256 or 512:
parameters, optimizer state, batch and cache are fake tensors
(``FakeTensorMode``, no storage) wrapped as DTensors with the placements the
axis rules give, and the step (``launch.specs.build_cell``) runs through
DTensor's sharding propagation, its collectives no-ops.  Below DTensor, on
rank 0's local shards, :class:`LocalCounter` counts:

  * flops, with ``torch.utils.flop_counter``'s formulas (a ``FlopCounterMode``
    above DTensor would count the global op);
  * bytes, every non-view aten op's inputs and outputs: an unfused count;
  * transcendentals, the elements of exp/log/tanh/rsqrt/... outputs;
  * one (op, result bytes, group size) record per ``_c10d_functional``
    collective, priced by ``hlo_analysis.parse_collectives``'s ring model;

and ``torch.distributed._tools.mem_tracker.MemTracker`` the peak of live
local bytes (``fits_hbm`` against the card's 80 GB).  Eager execution has
no buffer donation: the old and the new train state are both live at the
end of a train step.  Remat (``ModelConfig.remat``) recomputes the blocks
inside the counted backward pass, as XLA's HLO does.  Eager tracing counts
every layer, so the reference's 1-/2-unit probe extrapolation is not needed:
``--probe`` traces the full depth and writes the probe record's keys.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--jobs N]
  python -m repro_torch.launch.dryrun --arch ... --shape ... --rules fsdp --probe

Each cell writes experiments/dryrun_torch/<mesh>/<arch>__<shape>__<rules>.json
(``__probe`` before ``.json`` with ``--probe``), read by
``repro_torch.core.cost_model`` and the ``roofline`` benchmark section.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
from dataclasses import replace
from pathlib import Path

import torch

from ..configs import ARCH_IDS, SHAPES, cells, get_config
from ..core import cost_model
from ..sharding.rules import (
    DEFAULT_RULES,
    FSDP_RULES,
    PUREDP_RULES,
    QROWS_RULES,
    local_shape,
    mesh_context,
)
from .hlo_analysis import (
    COLLECTIVE_NAMES,
    HBM_BW,
    HBM_PER_CHIP,
    ICI_BW,
    PEAK_FLOPS,
    analyze,
    model_flops_for_cell,
    parse_collectives,
)

RULES = {"default": DEFAULT_RULES, "fsdp": FSDP_RULES,
         "puredp": PUREDP_RULES, "qrows": QROWS_RULES}

COUNTING_NOTE = ("eager trace on fake DTensors, rank 0's local shards; every "
                 "layer counted; remat recomputed in the backward pass; bytes "
                 "are each non-view op's inputs and outputs (unfused); no "
                 "buffer donation")

_TRANSCENDENTAL = frozenset({
    "exp", "exp2", "expm1", "log", "log1p", "log2", "tanh", "sigmoid", "rsqrt",
    "sin", "cos", "erf", "erfc", "silu", "gelu", "softplus", "_softmax",
    "_log_softmax", "logsumexp", "pow", "reciprocal", "sqrt",
    "silu_backward", "gelu_backward", "tanh_backward", "sigmoid_backward",
    "_softmax_backward_data"})
_FREE = frozenset({"empty", "empty_strided", "empty_like", "detach", "lift_fresh",
                   "_local_scalar_dense", "wait_tensor", "zeros_like_", "device",
                   "new_empty", "new_empty_strided", "alias", "clone_"})

@contextlib.contextmanager
def _alltoall_as_on_cards():
    """On a CPU mesh DTensor replaces a shard-to-shard all-to-all by an
    all-gather and a chunk (gloo has no all-to-all); the dry run stands for
    NCCL on cards, so it issues the all-to-all op, which the fake group
    answers."""
    from torch.distributed.tensor import placement_types

    orig = getattr(placement_types, "shard_dim_alltoall", None)
    if orig is None:                   # a release that imports it elsewhere
        yield
        return

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = mesh.get_group(mesh_dim)
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, group.group_name)

    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig


def _under_fake_mode() -> bool:
    """True inside DTensor's own shape propagation, which runs ops under a
    FakeTensorMode of its own (the dry run's step runs under none)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    return any(isinstance(m, FakeTensorMode) for m in _get_current_dispatch_mode_stack())


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class LocalCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts flops, bytes, transcendentals and collectives of the aten ops
    that run on local (non-DTensor) tensors: with DTensor arguments it
    returns NotImplemented, so DTensor unwraps the op and the local op comes
    back through this mode."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.records: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        try:
            out = func(*args, **kwargs)
        except (RuntimeError, ValueError):
            if func is not torch.ops.aten.view.default:
                raise
            # DTensor can hand a local shard strides that the global tensor's
            # view allows and the shard's does not (a MoE einsum's backward):
            # copy it first, as reshape would; the copy is counted
            src = torch.ops.aten.clone.default(
                args[0], memory_format=torch.contiguous_format)
            self._count(torch.ops.aten.clone.default, (args[0],), {}, src)
            args = (src, *args[1:])
            out = func(*args, **kwargs)
        if not _under_fake_mode():
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        packet = func._overloadpacket
        ns, name = func.namespace, packet.__name__
        if ns in ("_c10d_functional", "_dtensor"):
            op = COLLECTIVE_NAMES.get(name)
            if op is not None:
                self.records.append((op, sum(_nbytes(t) for t in _tensors(out)),
                                     _group_size(func, args, kwargs)))
            return
        if packet in self.flop_registry:
            self.flops += self.flop_registry[packet](*args, **kwargs, out_val=out)
        if ns != "aten" or func.is_view or name in _FREE:
            return
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.bytes += sum(_nbytes(t) for t in _tensors(out))
        if name.rstrip("_") in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in _tensors(out))


def _group_size(func, args, kwargs) -> int | None:
    """The process group's size of a functional collective (its
    ``group_name`` argument)."""
    import torch.distributed as dist

    names = [a.name for a in func._schema.arguments]
    vals = dict(zip(names, args)) | kwargs
    if "group_size" in vals:
        return int(vals["group_size"])
    group = vals.get("group_name")
    if group is None:
        return None
    return dist.distributed_c10d._resolve_process_group(group).size()


# ---------------------------------------------------------------------------
# Staging
# ---------------------------------------------------------------------------

def init_fake_world(world_size: int) -> None:
    """Make the ``fake`` process group of ``world_size`` ranks current (this
    process is rank 0), replacing another fake group of a different size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world_size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def mesh_name_of(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def production_mesh(multi_pod: bool):
    from .mesh import make_production_mesh

    init_fake_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod)


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(stride))


def fake_dtensor(meta: torch.Tensor, sharding):
    """A DTensor of ``meta``'s global shape and dtype with ``sharding``'s
    placements, its local shard a fake tensor (call under a
    ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor

    mesh, placements = sharding
    local = torch.empty(local_shape(tuple(meta.shape), mesh, placements),
                        dtype=meta.dtype)
    return DTensor.from_local(local, mesh, list(placements), run_check=False,
                              shape=meta.shape, stride=_contiguous_stride(meta.shape))


def stage_args(args_tree, shardings_tree):
    """``fake_dtensor`` over a tree of meta tensors and its tree of
    shardings (dicts and (named) tuples, as ``build_cell`` gives them)."""
    if isinstance(args_tree, torch.Tensor):
        return fake_dtensor(args_tree, shardings_tree)
    if isinstance(args_tree, dict):
        return {k: stage_args(v, shardings_tree[k]) for k, v in args_tree.items()}
    if isinstance(args_tree, tuple) and hasattr(args_tree, "_fields"):
        return type(args_tree)(*(stage_args(a, s)
                                 for a, s in zip(args_tree, shardings_tree)))
    if isinstance(args_tree, (list, tuple)):
        return type(args_tree)(stage_args(a, s)
                               for a, s in zip(args_tree, shardings_tree))
    return args_tree


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in _tensors(tree))


@contextlib.contextmanager
def extra_shape(name: str, seq: int, batch: int, kind: str):
    """Register a shape beside ``configs.SHAPES`` for one dry run (the
    reference's probe shapes do the same)."""
    SHAPES[name] = (seq, batch, kind)
    try:
        yield name
    finally:
        del SHAPES[name]


def count_cell(cfg, shape: str, mesh, rules) -> tuple:
    """Stage ``cfg`` x ``shape`` on ``mesh`` (the current process group's)
    and run its step once under the counters.  Returns (cell, counts, trace
    seconds); ``counts`` is what ``hlo_analysis.analyze`` takes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    from .specs import build_cell

    cell = build_cell(cfg, shape, mesh, rules)
    t0 = time.perf_counter()
    # the arguments are fake; the step runs outside the fake mode, so that
    # DTensor's own index arithmetic stays real (ops on fake tensors enter
    # their mode by themselves, and the step's small constants are real)
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = tuple(stage_args(a, s)
                     for a, s in zip(cell.args_sds, cell.in_shardings))
    arg_bytes = _local_bytes(args)
    tracker = MemTracker()
    tracker.track_external(*[t.to_local() for t in _tensors(args)])
    counter = LocalCounter()
    with mesh_context(mesh), _alltoall_as_on_cards(), tracker, counter:
        out = cell.fn(*args)
    out_bytes = _local_bytes(out)
    peak = max(int(v.get("Total", 0))
               for v in tracker.get_tracker_snapshot("peak").values())
    seconds = time.perf_counter() - t0
    memory_stats = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                    "temp_bytes": max(peak - arg_bytes, 0), "alias_bytes": 0,
                    "peak_bytes": peak}
    counts = {"flops": counter.flops, "bytes": counter.bytes,
              "transcendentals": counter.transcendentals,
              "records": counter.records, "memory_stats": memory_stats}
    return cell, counts, seconds


def _config(arch: str, config_overrides: dict | None):
    cfg = get_config(arch)
    return replace(cfg, **config_overrides) if config_overrides else cfg


def _write(mesh_name: str, name: str, rec: dict) -> Path:
    out_dir = cost_model.DRYRUN_DIR / mesh_name
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / name
    path.write_text(json.dumps(rec, indent=1))
    return path


def run_cell(arch: str, shape: str, multi_pod: bool, rules_name: str = "default",
             verbose: bool = True, config_overrides: dict | None = None, *,
             cfg=None, mesh=None) -> dict:
    """Trace one cell and write its record.  ``cfg`` (default
    ``get_config(arch)``) and ``mesh`` (default the production mesh on the
    fake group) may be given, as the tests give smoke ones."""
    cfg = cfg or _config(arch, config_overrides)
    mesh = mesh or production_mesh(multi_pod)
    mesh_name = mesh_name_of(multi_pod)
    cell, counts, seconds = count_cell(cfg, shape, mesh, RULES[rules_name])
    roof = analyze(counts, arch=arch, shape=shape, mesh_name=mesh_name,
                   num_devices=mesh.size(),
                   model_flops_global=model_flops_for_cell(cfg, shape))
    rec = roof.to_dict()
    rec.update(kind=cell.kind, rules=rules_name, trace_seconds=round(seconds, 2),
               counting=COUNTING_NOTE)
    _write(mesh_name, f"{arch}__{shape}__{rules_name}.json", rec)
    if verbose:
        print(f"[{mesh_name}] {arch} x {shape} ({rules_name}): "
              f"compute={roof.compute_seconds*1e3:.2f}ms "
              f"memory={roof.memory_seconds*1e3:.2f}ms "
              f"collective={roof.collective_seconds*1e3:.2f}ms "
              f"dominant={roof.dominant} useful={roof.useful_flops_ratio:.3f} "
              f"peak={roof.memory_stats['peak_bytes']/1e9:.2f}GB "
              f"fits_hbm={roof.fits_hbm} (trace {seconds:.1f}s)")
    return rec


def probe_roofline(arch: str, shape: str, multi_pod: bool,
                   rules_name: str = "default", verbose: bool = True,
                   config_overrides: dict | None = None, *, cfg=None,
                   mesh=None) -> dict:
    """The probe record (the reference's keys) of a full-depth trace: the
    reference extrapolates from 1- and 2-unit probes because XLA counts a
    scanned loop body once; eager tracing counts every layer.  ``cfg`` and
    ``mesh`` as :func:`run_cell`'s."""
    cfg = cfg or _config(arch, config_overrides)
    mesh = mesh or production_mesh(multi_pod)
    mesh_name = mesh_name_of(multi_pod)
    unit = cfg.hybrid_attn_every if cfg.family == "hybrid" else 1
    total_units = cfg.num_layers // unit
    cell, counts, seconds = count_cell(cfg, shape, mesh, RULES[rules_name])
    num_devices = mesh.size()
    colls = parse_collectives(counts["records"], num_devices)
    flops, byts, wire = float(counts["flops"]), float(counts["bytes"]), colls.wire_bytes
    mf = model_flops_for_cell(cfg, shape)
    compute_s, memory_s, coll_s = flops / PEAK_FLOPS, byts / HBM_BW, wire / ICI_BW
    peak = counts["memory_stats"]["peak_bytes"]
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_name, "rules": rules_name,
        "num_devices": num_devices, "probe_units": [total_units],
        "seq_fit": False,
        "total_units": total_units,
        "flops_per_device": flops, "bytes_per_device": byts,
        "transcendentals": float(counts["transcendentals"]),
        "collective_wire_bytes": wire,
        "collective_payload_bytes": colls.payload_bytes,
        "collectives": colls.counts, "collective_bytes_by_op": colls.by_op_bytes,
        "compute_seconds": compute_s, "memory_seconds": memory_s,
        "collective_seconds": coll_s,
        "dominant": max((("compute", compute_s), ("memory", memory_s),
                         ("collective", coll_s)), key=lambda kv: kv[1])[0],
        "model_flops_global": mf,
        "useful_flops_ratio": mf / (flops * num_devices) if flops else 0.0,
        "memory_stats": counts["memory_stats"],
        "fits_hbm": bool(peak <= HBM_PER_CHIP),
        "kind": cell.kind, "trace_seconds": round(seconds, 2),
        "counting": COUNTING_NOTE,
    }
    _write(mesh_name, f"{arch}__{shape}__{rules_name}__probe.json", rec)
    if verbose:
        print(f"[probe {mesh_name}] {arch} x {shape} ({rules_name}): "
              f"compute={compute_s*1e3:.2f}ms memory={memory_s*1e3:.2f}ms "
              f"collective={coll_s*1e3:.2f}ms dominant={rec['dominant']} "
              f"useful={rec['useful_flops_ratio']:.3f} "
              f"peak={peak/1e9:.2f}GB fits_hbm={rec['fits_hbm']} "
              f"(trace {seconds:.1f}s)")
    return rec


def run_all(multi_pod: bool, rules_name: str, jobs: int) -> int:
    """Fan each cell out to a subprocess (one process group a cell)."""
    import subprocess
    todo = cells()
    procs: list = []
    failed = []
    done = 0

    def launch(a, s):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", a, "--shape", s, "--rules", rules_name, "--quiet"]
        if multi_pod:
            cmd.append("--multi-pod")
        env = dict(os.environ)
        env["PYTHONPATH"] = str(Path(__file__).resolve().parents[2])
        return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    queue = list(todo)
    while queue or procs:
        while queue and len(procs) < jobs:
            a, s = queue.pop(0)
            procs.append((a, s, launch(a, s)))
        a, s, p = procs.pop(0)
        out, _ = p.communicate()
        done += 1
        status = "ok" if p.returncode == 0 else "FAIL"
        print(f"[{done}/{len(todo)}] {a} x {s}: {status}")
        if p.returncode != 0:
            failed.append((a, s))
            print(out[-4000:])
    if failed:
        print("FAILED CELLS:", failed)
        return 1
    print(f"all {len(todo)} cells traced on "
          f"{'2x16x16' if multi_pod else '16x16'} mesh")
    return 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rules", default="default",
                    choices=list(RULES) + ["preferred"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--probe", action="store_true",
                    help="write the probe record (full-depth trace)")
    ap.add_argument("--bf16-attn", action="store_true",
                    help="bf16 attention softmax (default fp32)")
    ap.add_argument("--remat", default=None, choices=["none", "full", "dots"])
    ap.add_argument("--tag", default=None,
                    help="suffix for the output json (perf-iteration runs)")
    args = ap.parse_args(argv)

    if args.all:
        sys.exit(run_all(args.multi_pod, args.rules, args.jobs))
    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --all)")
    if args.rules == "preferred":
        from ..configs import preferred_rules_name
        args.rules = preferred_rules_name(args.arch, args.shape)
        print(f"preferred rules for {args.arch} x {args.shape}: {args.rules}")
    overrides = {}
    if args.bf16_attn:
        overrides["attn_logits_fp32"] = False
    if args.remat:
        overrides["remat"] = args.remat
    try:
        if args.probe:
            rec = probe_roofline(args.arch, args.shape, args.multi_pod, args.rules,
                                 verbose=not args.quiet,
                                 config_overrides=overrides or None)
        else:
            rec = run_cell(args.arch, args.shape, args.multi_pod, args.rules,
                           verbose=not args.quiet,
                           config_overrides=overrides or None)
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    if args.tag:
        suffix = "__probe" if args.probe else ""
        _write(mesh_name_of(args.multi_pod),
               f"{args.arch}__{args.shape}__{args.rules}{suffix}__{args.tag}.json", rec)


if __name__ == "__main__":
    main()
