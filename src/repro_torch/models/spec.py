"""Declarative parameters and their random initialisation.

The port's own copy of the reference's ``ParamSpec``
(``repro.sharding.rules``) and ``init_from_specs``
(``repro.models.layers``).  A model is described by a nested dict of
:class:`ParamSpec` leaves; :func:`init_from_specs` turns it into the same
nested dict of tensors.  The logical axes are kept as documentation and for
the specs' shapes; the port runs on one card, so it has no axis rules and
no sharding constraints yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch


@dataclass(frozen=True)
class ParamSpec:
    """Declarative parameter: shape + dtype + logical axes (+ init scale)."""

    shape: tuple[int, ...]
    logical_axes: tuple[str | None, ...]
    dtype: Any = torch.float32
    init: str = "normal"     # normal | zeros | ones | fan_in
    init_scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(f"shape {self.shape} vs axes {self.logical_axes}")


def tree_map(fn: Callable, tree, is_leaf: Callable = lambda x: isinstance(x, ParamSpec)):
    """``fn`` over every leaf of nested dicts, lists and (named) tuples, in
    the tree's own structure.  ``None`` is an empty subtree."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def tree_leaves(tree, is_leaf: Callable = lambda x: isinstance(x, ParamSpec)) -> list:
    """The leaves of ``tree``, dict keys in sorted order (JAX's order)."""
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v, is_leaf)]
    if tree is None:
        return []
    return [tree]


def _fill(spec: ParamSpec, generator: torch.Generator, dtype, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "normal":
        std = spec.init_scale
    elif spec.init == "fan_in":
        fan_in = spec.shape[0] if len(spec.shape) == 1 else math.prod(spec.shape[:-1])
        std = 1.0 / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(spec.init)
    t = torch.empty(spec.shape, dtype=torch.float32, device=device)
    t.normal_(0.0, std, generator=generator)
    return t if dtype == torch.float32 else t.to(dtype)


def init_from_specs(specs, generator: torch.Generator, param_dtype=torch.float32,
                    device=None):
    """Materialise a ParamSpec tree into tensors on ``device``, drawing
    from ``generator`` (on that device) leaf by leaf in sorted key order:
    N(0, init_scale) for ``normal``, N(0, 1 / fan_in) for ``fan_in`` (fan_in
    the product of all but the last axis), zeros and ones.  A spec's own
    dtype wins over ``param_dtype``."""
    filled = {id(s): _fill(s, generator, s.dtype if s.dtype is not None
                           else param_dtype, device)
              for s in tree_leaves(specs)}
    return tree_map(lambda s: filled[id(s)], specs)
