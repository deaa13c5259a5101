"""Streaming control plane of the port: online multi-device, multi-tenant
GP-EI under tenant churn, event-sourced.

The counterpart of ``repro.stream``: seeded churn traces (``workload.py``),
the event loop over a device ``Fleet`` (``engine.py``), the service
telemetry (``telemetry.py``), and the append-only event log with snapshots
and crash recovery (``eventlog.py``, snapshots through
``repro_torch.checkpoint``).  The per-event math is the port's
``core.control_plane.ControlPlane``; with churn disabled the engine
reproduces ``scheduler.simulate``'s trial sequence, and on the reference's
traces it gives the reference's trial sequences
(tests/test_torch_stream.py).  The device side goes elastic in
``repro_torch.devplane``.
"""

from .engine import StreamEngine, StreamResult, StreamTrial  # noqa: F401
from .eventlog import (  # noqa: F401
    EventLog,
    FaultInjector,
    SimulatedCrash,
    first_divergence,
    recover,
)
from .telemetry import TelemetrySink  # noqa: F401
from .workload import (  # noqa: F401
    ChaosTrace,
    ChurnTrace,
    DeviceJoin,
    DeviceLeave,
    DevicePreempt,
    MeshShrink,
    SliceFail,
    TenantArrive,
    TenantDepart,
    TrialHang,
    TrialPoison,
    chaos_trace,
    device_churn_trace,
    poisson_churn_trace,
    trace_from_problem,
)
