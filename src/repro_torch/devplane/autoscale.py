"""Queue-depth-driven fleet autoscaling (DESIGN.md §11); the port's copy of
``repro.devplane.autoscale``.

The signal is *backlog per device*: the number of live, unselected models
(work the policy still wants to run — warm-start entries and future EIrate
picks alike) divided by the in-fleet device count.  Sustained backlog above
``high_backlog`` joins a device of ``join_class``; backlog below
``low_backlog`` with an idle device retires the slowest free slice.  A
``cooldown`` between actions damps oscillation, and ``min_devices`` /
``max_devices`` bound the fleet.  Everything is a pure function of engine
state at event times, so autoscaled replays are deterministic.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class AutoscalePolicy:
    """Thresholds + bounds; the engine calls :meth:`decide` after every
    event and applies the returned action (see module docstring)."""

    high_backlog: float = 4.0    # unselected live models per device => join
    low_backlog: float = 1.0     # below this with an idle device => leave
    cooldown: float = 10.0       # min seconds between actions
    join_class: str = "base"     # device class joins are drawn from
    min_devices: int = 1
    max_devices: int = 64
    # cooldown clock — run state, not configuration: init=False so
    # dataclasses.replace() yields a fresh clock (the engine copies the
    # policy at construction; a caller-held instance is never mutated)
    _last_action: float = field(default=float("-inf"), repr=False,
                                init=False)

    def __post_init__(self):
        if self.low_backlog >= self.high_backlog:
            raise ValueError("low_backlog must be < high_backlog")
        if not 1 <= self.min_devices <= self.max_devices:
            raise ValueError("need 1 <= min_devices <= max_devices")

    def ready(self, t: float) -> bool:
        """Cheap cooldown precheck — lets the engine skip computing the
        backlog (an O(capacity) scan) on the common no-action path."""
        return t - self._last_action >= self.cooldown

    def decide(self, t: float, *, backlog: int, num_devices: int,
               num_free: int) -> str | None:
        """``"join"``, ``"leave"``, or None.  Mutates the cooldown clock
        when an action is returned."""
        if num_devices < 1 or not self.ready(t):
            return None
        per_device = backlog / num_devices
        if per_device > self.high_backlog and num_devices < self.max_devices:
            self._last_action = t
            return "join"
        if (per_device < self.low_backlog and num_free > 0
                and num_devices > self.min_devices):
            self._last_action = t
            return "leave"
        return None


__all__ = ["AutoscalePolicy"]
