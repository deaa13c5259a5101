"""Observability of the port: so far the decision-path tracer only
(``trace.py``); metrics, export, health, forensics and accounting arrive
with the observability slice."""

from .trace import NULL_TRACER, Tracer  # noqa: F401
