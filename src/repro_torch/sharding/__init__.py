"""Logical-axis sharding rules of the data plane, on DTensor
(counterpart of ``repro.sharding``)."""

from .rules import (  # noqa: F401
    AxisRules,
    DEFAULT_RULES,
    FSDP_RULES,
    ParamSpec,
    logical_sharding,
    logical_to_pspec,
    shardings_for_tree,
    shape_dtype_for_tree,
    with_logical_constraint,
)
