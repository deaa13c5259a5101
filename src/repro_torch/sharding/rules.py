"""Logical-axis sharding rules (MaxText-style) for the model substrate, on
DTensor.

Counterpart of ``repro.sharding.rules``.  Every parameter and activation is
annotated with *logical* axis names ("embed", "heads", "mlp", "experts",
"batch", ...).  An :class:`AxisRules` table maps logical names to mesh axes
("pod", "data", "model"); the same six tables as the reference's.  Where
JAX turns a table into a ``PartitionSpec`` and a ``NamedSharding``, the
port turns it into a partition spec (a tuple, one entry per tensor dim:
None, a mesh axis name, or a tuple of them) and then into DTensor
placements over a named ``DeviceMesh``: a dim mapped to several mesh axes
is ``Shard(d)`` on each of them, which DTensor splits in mesh-dim order,
the reference's major-to-minor order.

Parallelism styles expressed through rules:
  DP    batch -> ("pod", "data")
  TP    heads / kv_heads / mlp / vocab / experts_mlp -> "model"
  EP    experts -> "model"  (MoE all-to-all over the model axis)
  FSDP  embed -> "data"     (params additionally sharded over the data axis,
                             all-gathered at use; ZeRO-3 style)
  SP    kv_seq -> "data"    (long-context decode: KV/state sharded over seq)

``with_logical_constraint`` is the counterpart of
``jax.lax.with_sharding_constraint``: under :func:`mesh_context` it
redistributes a DTensor to the placements of its logical axes; with
``rules=None``, outside a mesh, or on a plain tensor it returns its input.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Any

import torch

PSpec = tuple   # one entry per dim: None | mesh axis name | tuple of names


@dataclass(frozen=True)
class AxisRules:
    """Mapping logical axis name -> mesh axis (or tuple of mesh axes, or None)."""

    rules: tuple[tuple[str, Any], ...]

    def lookup(self, name: str | None):
        if name is None:
            return None
        for key, val in self.rules:
            if key == name:
                return val
        return None

    def override(self, **kwargs) -> "AxisRules":
        new = dict(self.rules)
        new.update(kwargs)
        return AxisRules(tuple(new.items()))

    def mesh_axes(self, logical_axes: tuple[str | None, ...]) -> PSpec:
        used: list = []
        parts = []
        for name in logical_axes:
            ax = self.lookup(name)
            # A mesh axis may appear at most once in a partition spec; later
            # logical axes that map to an already-used mesh axis stay
            # replicated (standard MaxText behaviour).
            if ax is None:
                parts.append(None)
                continue
            ax_t = ax if isinstance(ax, tuple) else (ax,)
            ax_t = tuple(a for a in ax_t if a not in used)
            if not ax_t:
                parts.append(None)
            elif len(ax_t) == 1:
                parts.append(ax_t[0])
                used.append(ax_t[0])
            else:
                parts.append(ax_t)
                used.extend(ax_t)
        return tuple(parts)


# Baseline rules: DP over (pod, data), TP/EP over model.  This is the
# paper-faithful production default; FSDP_RULES adds ZeRO-3 param sharding
# (used by the large MoE configs).
DEFAULT_RULES = AxisRules((
    ("batch", ("pod", "data")),
    ("seq", None),
    ("kv_seq", None),
    ("embed", None),
    ("embed_out", None),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("head_dim", None),
    ("mlp", "model"),
    ("vocab", "model"),
    ("experts", "model"),
    ("expert_mlp", None),
    ("ssm_inner", "model"),
    ("ssm_state", None),
    ("ssm_heads", "model"),
    ("conv_width", None),
    ("layers", None),
    ("act_embed", None),
    ("act_heads", "model"),
    ("q_rows", None),
))

FSDP_RULES = DEFAULT_RULES.override(
    embed="data",          # shard the non-TP dim of weight matrices over data
    expert_mlp="data",
)

# Long-context decode: KV cache / attention over sequence sharded on data.
SP_DECODE_RULES = DEFAULT_RULES.override(kv_seq="data")

# Pure data-parallel + ZeRO-3 (no tensor parallelism): the batch is sharded
# over every mesh axis and parameters are fully sharded for storage
# (all-gathered at use).  No per-layer activation all-reduces at all.
PUREDP_RULES = AxisRules((
    ("batch", ("pod", "data", "model")),
    ("seq", None), ("kv_seq", None),
    ("embed", "data"),
    ("embed_out", None),
    ("heads", "model"), ("kv_heads", "model"), ("head_dim", None),
    ("mlp", "model"),
    ("vocab", "model"),
    ("experts", "model"), ("expert_mlp", "data"),
    ("ssm_inner", "model"), ("ssm_state", None), ("ssm_heads", "model"),
    ("conv_width", None), ("layers", None),
    ("act_embed", None), ("act_heads", None), ("q_rows", None),
))

# Query-row sharded attention: for archs whose head counts don't divide the
# model axis (musicgen 24H), shard each attention chunk's query rows instead
# of heads.  Params stay TP-sharded where divisible.
QROWS_RULES = DEFAULT_RULES.override(q_rows="model", act_heads=None)

# Sharded GP-EI scoring plane (repro_torch.shardgp): control-plane state is
# logically (tenants, models) / (obs, models); only the model axis shards.
SCORING_RULES = AxisRules((
    ("models", "shard"),
    ("tenants", None),
    ("obs", None),
))


def logical_to_pspec(spec: ParamSpec | tuple[str | None, ...], rules: AxisRules) -> PSpec:
    axes = spec.logical_axes if isinstance(spec, ParamSpec) else spec
    return rules.mesh_axes(axes)


def _mesh_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _sanitize_pspec(spec: PSpec, shape: tuple[int, ...], mesh) -> PSpec:
    """Drop partitions whose dim isn't divisible by the mapped mesh extent
    (e.g. MQA's single KV head on a 16-way model axis -> replicate, where
    DTensor would shard unevenly), and axes absent from this mesh (e.g.
    "pod" on the single-pod mesh)."""
    sizes = _mesh_sizes(mesh)
    parts = []
    for i, part in enumerate(spec):
        if part is None or i >= len(shape):
            parts.append(None)
            continue
        ax_t = part if isinstance(part, tuple) else (part,)
        ax_t = tuple(a for a in ax_t if a in sizes)
        extent = math.prod(sizes[a] for a in ax_t)
        if not ax_t or extent == 0 or shape[i] % extent != 0:
            parts.append(None)
        elif len(ax_t) == 1:
            parts.append(ax_t[0])
        else:
            parts.append(ax_t)
    return tuple(parts)


def pspec_to_placements(spec: PSpec, mesh) -> tuple:
    """DTensor placements of a (sanitised) partition spec: ``Shard(d)`` on
    every mesh dim of extent above 1 that tensor dim d is mapped to,
    ``Replicate()`` on the rest (an axis of extent 1 splits nothing, and
    some DTensor releases refuse to flatten a dim marked sharded).  DTensor
    splits a dim held by several mesh dims in mesh-dim order, so a tuple
    must list its axes in the mesh's order (every table above does)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    placements = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        ax_t = part if isinstance(part, tuple) else (part,)
        idx = [names.index(a) for a in ax_t]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} is mapped to {ax_t}, not in the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            if mesh.shape[i] > 1:
                placements[i] = Shard(d)
    return tuple(placements)


def logical_sharding(spec: ParamSpec | tuple[str | None, ...], mesh,
                     rules: AxisRules) -> tuple:
    """``(mesh, placements)`` of a ParamSpec (sanitised against its shape)
    or of bare logical axes: the counterpart of the reference's
    ``NamedSharding``."""
    pspec = logical_to_pspec(spec, rules)
    if isinstance(spec, ParamSpec):
        pspec = _sanitize_pspec(pspec, spec.shape, mesh)
    return mesh, pspec_to_placements(pspec, mesh)


def shardings_for_tree(tree, mesh, rules: AxisRules):
    """Map a tree of ParamSpec -> tree of ``(mesh, placements)``."""
    return tree_map(lambda s: logical_sharding(s, mesh, rules), tree)


def shape_dtype_for_tree(tree):
    """Map a tree of ParamSpec -> tree of meta tensors (no allocation)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), tree)


def local_shape(shape: tuple[int, ...], mesh, placements) -> tuple[int, ...]:
    """The shape of one rank's shard (every shard of a sanitised spec is the
    same size)."""
    out = list(shape)
    for size, p in zip(mesh.shape, placements):
        if p.is_shard():
            out[p.dim] //= size
    return tuple(out)


def distribute_tree(tree, specs, mesh, rules: AxisRules):
    """Each tensor of ``tree`` distributed (``distribute_tensor``: every
    rank passes the same full tensor, as ``jax.device_put`` places one
    array) to the placements that the ParamSpec at the same place in
    ``specs`` gives (``specs`` fixes the structure: dicts, named tuples,
    lists)."""
    if isinstance(specs, ParamSpec):
        from torch.distributed.tensor import distribute_tensor

        _, placements = logical_sharding(specs, mesh, rules)
        return distribute_tensor(tree, mesh, list(placements))
    if isinstance(specs, dict):
        return {k: distribute_tree(tree[k], v, mesh, rules) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(tree)(*(distribute_tree(t, s, mesh, rules)
                            for t, s in zip(tree, specs)))
    if isinstance(specs, (list, tuple)):
        return type(tree)(distribute_tree(t, s, mesh, rules)
                          for t, s in zip(tree, specs))
    return tree


def placed_like(tree, like):
    """``tree`` with every DTensor redistributed to the placements of the
    DTensor at the same place in ``like``: a jitted step's
    ``out_shardings`` equal to its ``in_shardings`` (DTensor otherwise keeps
    whatever placements its sharding propagation chose)."""
    from torch.distributed.tensor import DTensor

    if isinstance(like, DTensor):
        if tuple(tree.placements) == tuple(like.placements):
            return tree
        return tree.redistribute(like.device_mesh, like.placements)
    if isinstance(like, dict):
        return {k: placed_like(tree[k], v) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(tree)(*(placed_like(t, s) for t, s in zip(tree, like)))
    if isinstance(like, (list, tuple)):
        return type(tree)(placed_like(t, s) for t, s in zip(tree, like))
    return tree


def splittable(x, dim: int, outer: int):
    """``x`` with dim ``dim`` ready to be split into (outer, size / outer):
    a DTensor sharded on it over mesh extent that does not divide ``outer``
    is replicated there first (GSPMD reshards such a reshape by itself;
    DTensor refuses it).  Plain tensors pass through."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    mesh, placements = x.device_mesh, list(x.placements)
    extent = math.prod(size for size, p in zip(mesh.shape, placements)
                       if p.is_shard(dim))
    if outer % extent == 0:
        return x
    placements = [Replicate() if p.is_shard(dim) else p for p in placements]
    return x.redistribute(mesh, placements)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def on_shards(fn, x, whole=(), *args):
    """``fn(x_local, *args)`` on each rank's shard of the DTensor ``x`` with
    the dims ``whole`` unsplit (gathered first where split): for ops along
    an unsplit dim that DTensor has no rule for (``roll``, ``pad``,
    ``index_copy``, the ``flip`` of ``cumsum``'s backward) in some
    releases.  A DTensor in ``args`` (of x's rank) is placed as x and
    passed as its local shard; a replicated 0- or 1-d one as its value.
    The result keeps x's placements; its split dims keep their sizes.
    Plain tensors: ``fn(x, *args)``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return fn(x, *args)
    mesh = x.device_mesh
    whole = [d % x.ndim for d in whole]
    px = [Replicate() if p.is_partial() or any(p.is_shard(d) for d in whole) else p
          for p in x.placements]
    if list(x.placements) != px:
        x = x.redistribute(mesh, px)

    def local_of(a):
        if not isinstance(a, DTensor):
            return a
        if a.ndim == x.ndim:
            return (a if list(a.placements) == px else a.redistribute(mesh, px)).to_local()
        return a.full_tensor()

    local = fn(x.to_local(), *map(local_of, args))
    shape = list(local.shape)
    for size, p in zip(mesh.shape, px):
        if p.is_shard():
            shape[p.dim] *= size
    return _wrap(local, mesh, px, shape)


def _wrap(local: torch.Tensor, mesh, placements, shape):
    """The DTensor of global ``shape`` whose shard here is ``local``, its
    global strides in the local tensor's dim order (a result may be a
    permuted view)."""
    from torch.distributed.tensor import DTensor

    stride, acc = [0] * len(shape), 1
    for i in sorted(range(len(shape)), key=lambda i: local.stride(i)):
        stride[i] = acc
        acc *= max(shape[i], 1)
    return DTensor.from_local(local, mesh, list(placements), run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def embedding(table, tokens):
    """``table[tokens]``; on DTensors, the vocab-parallel gather GSPMD
    makes: each rank gathers the rows of its vocab shard (others masked to
    zero), a partial sum over the vocab's mesh dims, the result split as the
    tokens are.  The table is whole along its rows' dim, and replicated
    where the tokens are split.  Plain tensors: ``table[tokens]``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    pt = [Replicate() if tk.is_shard() or not p.is_shard(0) else p
          for tk, p in zip(tokens.placements, table.placements)]
    if list(table.placements) != pt:
        table = table.redistribute(mesh, pt)
    rows, offset = compute_local_shape_and_global_offset(table.shape, mesh, pt)
    # the table's gradient: partial over the tokens' splits, split as its rows
    local_table = table.to_local(grad_placements=[
        Partial() if tk.is_shard() else p for tk, p in zip(tokens.placements, pt)])
    tok = tokens.to_local() - offset[0]
    inside = (tok >= 0) & (tok < rows[0])
    local = local_table[tok.clamp(0, rows[0] - 1)] * inside[..., None].to(local_table.dtype)
    placements = [Shard(tk.dim) if tk.is_shard() else Partial() if p.is_shard(0)
                  else Replicate() for tk, p in zip(tokens.placements, pt)]
    return _wrap(local, mesh, placements, (*tokens.shape, table.shape[1]))


def local_along(x, dim: int, *others):
    """For a computation on local shards: ``x`` (a DTensor) with ``dim``
    unsplit, and each of ``others`` (DTensors over x's last dim: a trailing
    dim of the same length) split on their last dim as x is on its last,
    replicated elsewhere.  Returns (x's local shard, the others' local
    shards, a function that wraps a local result shaped like x back into a
    DTensor with x's placements).  An other's gradient is a partial sum
    where x is split and it is not."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, nd = x.device_mesh, x.ndim
    dim %= nd
    px = [Replicate() if p.is_shard(dim) or p.is_partial() else p for p in x.placements]
    if list(x.placements) != px:
        x = x.redistribute(mesh, px)
    locals_ = []
    for o in others:
        po = [Shard(o.ndim - 1) if p.is_shard(nd - 1) else Replicate() for p in px]
        o = o if list(o.placements) == po else o.redistribute(mesh, po)
        grad = [Partial() if p.is_shard() and q.is_replicate() else q
                for p, q in zip(px, po)]
        locals_.append(o.to_local(grad_placements=grad))
    shape, stride = x.shape, x.stride()
    wrap = lambda local: DTensor.from_local(local, mesh, px, run_check=False,  # noqa: E731
                                            shape=shape, stride=stride)
    return x.to_local(), locals_, wrap


def einsum(equation: str, *operands):
    """``torch.einsum``; on DTensors, the einsum of each rank's local shards.

    GSPMD partitions an einsum by its labels; DTensor decomposes it into
    permutes, reshapes and a ``bmm``, and some releases refuse the reshape
    that folds two sharded dims.  So here each mesh dim splits at most one
    label: a label of the output if one is split over it (the result is
    sharded there), else a contracted one (the result is a partial sum
    there, as GSPMD's before its all-reduce); operands holding the label
    but not split on it are split locally (a chunk, no communication), and
    any other split over that mesh dim is gathered first.  The gradient of
    an operand that does not hold the label is a partial sum there.  Plain
    tensors count as replicated.  Without DTensor operands it is
    ``torch.einsum``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not any(isinstance(o, DTensor) for o in operands):
        return torch.einsum(equation, *operands)
    ins, out = equation.replace(" ", "").split("->")
    labels = ins.split(",")
    mesh = next(o for o in operands if isinstance(o, DTensor)).device_mesh
    ops = [o if isinstance(o, DTensor) else
           DTensor.from_local(o, mesh, [Replicate()] * mesh.ndim, run_check=False)
           for o in operands]
    sizes = {c: n for lab, o in zip(labels, ops) for c, n in zip(lab, o.shape)}
    chosen = []                            # mesh dim -> the label it splits
    for m in range(mesh.ndim):
        held = [lab[p.dim] for lab, o in zip(labels, ops)
                for p in [o.placements[m]] if p.is_shard()]
        kept = [c for c in held if c in out] or held
        chosen.append(kept[0] if kept else None)
    targets = []
    for lab, o in zip(labels, ops):
        want = [Shard(lab.index(c)) if c is not None and c in lab else Replicate()
                for c in chosen]
        targets.append(o if list(o.placements) == want else o.redistribute(mesh, want))
    # an operand not split where another is holds, on that mesh dim, a
    # gradient that is a partial sum over the other's shards
    local = torch.einsum(equation, *[
        o.to_local(grad_placements=[
            Partial() if c is not None and c not in lab else p
            for c, p in zip(chosen, o.placements)])
        for lab, o in zip(labels, targets)])
    placements = [Replicate() if c is None else Shard(out.index(c)) if c in out
                  else Partial() for c in chosen]
    # (the gradient of a partial result arrives replicated: from_local's own
    # backward keeps a replicated gradient where the forward was partial)
    return _wrap(local, mesh, placements, [sizes[c] for c in out])


# ---------------------------------------------------------------------------
# The ambient mesh and the activation constraint
# ---------------------------------------------------------------------------

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def mesh_context(mesh):
    """``with mesh_context(mesh):`` makes ``mesh`` current for
    :func:`with_logical_constraint` (the reference's ``set_mesh``).  Inside
    it a plain tensor meeting a DTensor counts as replicated (DTensor's
    ``implicit_replication``), as a traced constant does in a jitted
    SPMD program: positions, masks and zero accumulators stay plain."""
    from torch.distributed.tensor.experimental import implicit_replication

    token = _MESH.set(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The mesh of the innermost :func:`mesh_context`, or None."""
    return _MESH.get()


def with_logical_constraint(x, logical_axes: tuple[str | None, ...],
                            rules: AxisRules | None):
    """Constrain an activation to the placements of its logical axes.

    A no-op with ``rules=None``, outside a mesh context, or on a plain
    tensor, so model code runs unchanged on one device."""
    if rules is None:
        return x
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = _sanitize_pspec(rules.mesh_axes(logical_axes), tuple(x.shape), mesh)
    placements = pspec_to_placements(spec, mesh)
    if tuple(x.placements) == placements and x.device_mesh == mesh:
        return x
    return x.redistribute(mesh, placements)


# At the end: the models import ``with_logical_constraint`` from here, and
# importing ``models.spec`` runs the models package first.
from ..models.spec import ParamSpec, tree_map  # noqa: E402
