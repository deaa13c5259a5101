"""Elastic device plane of the port: heterogeneous fleets, device churn,
joint batched device<->model assignment (DESIGN.md §11).

The counterpart of ``repro.devplane``:

  registry.py   device classes and their affine per-class trial costs
  assign.py     the greedy joint assignment over per-class top-k candidates
  autoscale.py  queue-depth-driven fleet sizing
  quarantine.py per-device strike scoreboard (DESIGN.md §16)
  engine.py     DevPlaneEngine: StreamEngine + device join / leave / preempt,
                2-D costs, batched assignment, autoscale, quarantine

One batched scoring pass is ``ControlPlane.choose_mdmt_batch``: the
class-axis EIrate kernel (``kernels/csrc/ei_classes.cu``) on the card, then
a stable per-row top-k.
"""

from .assign import greedy_assign  # noqa: F401
from .autoscale import AutoscalePolicy  # noqa: F401
from .engine import ASSIGN_MODES, DevPlaneEngine  # noqa: F401
from .quarantine import QuarantineBoard, QuarantinePolicy  # noqa: F401
from .registry import (  # noqa: F401
    BASE_CLASS,
    REFERENCE_CHIPS,
    DeviceClass,
    DeviceClassRegistry,
    two_class_registry,
)
