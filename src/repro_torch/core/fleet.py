"""Device fleet (the port's copy of ``repro.core.fleet``, numpy only): the paper's M atomic devices = disjoint mesh slices.

A production pod (16x16) is partitioned into M equal slices (e.g. 16 slices
of 4x4 = 16 chips); each slice is the atomic unit a tenant trial occupies,
exactly the paper's device abstraction.  The fleet tracks health: a failed
slice kills its in-flight trial (the scheduler re-queues the model — it was
never observed, so it simply returns to L \\ L(t)) and rejoins after repair.

Heterogeneity: per-slice ``speed`` scales effective c(x); the MDMT policy is
device-aware through EIrate = EI(x) / (c(x)/speed_d) (a strict generalization
of eq. 5, see scheduler.py).  ``cls`` names the slice's *device class* in a
:class:`repro_torch.devplane.DeviceClassRegistry` — the registry gives
per-class affine trial costs, making the cost genuinely 2-D
over (device, model) instead of the rank-1 ``c(x)/speed_d`` (DESIGN.md §11).

Elasticity: slices can :meth:`join` (a new device arrives at runtime),
:meth:`leave` (permanently decommissioned — the in-flight trial dies like a
failure, but the slice never repairs), and be :meth:`preempt`-ed (the trial
is evicted, the slice is immediately schedulable again).  The streaming
device plane (``repro_torch.devplane``) drives all three from trace events.
"""

from __future__ import annotations

from dataclasses import dataclass, field

DEFAULT_CLASS = "base"


@dataclass
class DeviceSlice:
    slice_id: int
    chips: int
    speed: float = 1.0
    healthy: bool = True
    busy_until: float = 0.0
    current_trial: int | None = None
    cls: str = DEFAULT_CLASS       # device-class name (devplane registry key)
    retired: bool = False          # left the fleet for good (never recovers)


@dataclass
class Fleet:
    slices: list[DeviceSlice]

    @classmethod
    def partition_pod(cls, total_chips: int = 256, num_slices: int = 8,
                      speeds: list[float] | None = None) -> "Fleet":
        assert total_chips % num_slices == 0
        chips = total_chips // num_slices
        speeds = speeds or [1.0] * num_slices
        return cls([DeviceSlice(i, chips, speeds[i]) for i in range(num_slices)])

    @property
    def num_devices(self) -> int:
        """Devices currently in the fleet (retired slices keep their ids but
        no longer count — a joined replacement gets a fresh id)."""
        return sum(1 for s in self.slices if not s.retired)

    def free_at(self, t: float) -> list[DeviceSlice]:
        return [s for s in self.slices
                if s.healthy and not s.retired
                and s.current_trial is None and s.busy_until <= t]

    def fail(self, slice_id: int) -> int | None:
        """Mark slice failed; returns the killed trial id (to re-queue).

        The killed trial's reservation dies with it: ``busy_until`` is reset
        so a slice repaired before the old reservation would have expired is
        immediately schedulable."""
        s = self.slices[slice_id]
        s.healthy = False
        s.busy_until = 0.0
        killed, s.current_trial = s.current_trial, None
        return killed

    def recover(self, slice_id: int):
        self.slices[slice_id].healthy = True

    # ---- elasticity (the device plane's lifecycle verbs) --------------------

    def join(self, chips: int, speed: float = 1.0,
             cls: str = DEFAULT_CLASS) -> DeviceSlice:
        """A new slice arrives at runtime (cluster scale-up, a spot device
        granted).  Slice ids are append-only — a retired id is never reused,
        so pending completion events can never alias a new device."""
        s = DeviceSlice(len(self.slices), chips, speed, cls=cls)
        self.slices.append(s)
        return s

    def leave(self, slice_id: int) -> int | None:
        """Permanent decommission: the in-flight trial dies exactly like a
        slice failure (returns the killed trial id), but the slice is marked
        retired and never recovers."""
        killed = self.fail(slice_id)
        self.slices[slice_id].retired = True
        return killed

    def preempt(self, slice_id: int) -> int | None:
        """Evict the in-flight trial (returns its id to re-queue) but keep
        the slice healthy and immediately schedulable — the spot-market /
        higher-priority-work eviction, distinct from a failure's downtime."""
        s = self.slices[slice_id]
        s.busy_until = 0.0
        killed, s.current_trial = s.current_trial, None
        return killed
