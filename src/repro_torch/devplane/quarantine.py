"""Device quarantine: the failure-domain scoreboard (DESIGN.md §16); the
port's copy of ``repro.devplane.quarantine``.

A device that keeps timing out or failing is worse than a missing device:
the scheduler keeps feeding it trials, each one burns a full deadline
before the supervisor kills it, and the tenant's regret clock runs the
whole time.  :class:`QuarantineBoard` tracks a per-device strike history
(trial timeouts, slice failures) over a sliding window; when a device
accumulates ``threshold`` strikes inside ``window`` seconds it is pulled
from the launchable pool for ``duration`` seconds, then re-admitted *on
probation* — it must complete ``probation_trials`` clean trials before it
counts as healthy again, and a single strike during probation re-
quarantines it immediately (the "flap" the health plane pages on).

The board is pure host-side bookkeeping driven by sim-time values the
engine hands it, so it is deterministic under replay and snapshots into
the engine's crash-recovery state (``state_dict``/``load_state``).

Capacity coupling: the devplane engine subtracts ``quarantined_now()``
from the device count it reports to the autoscale controller, so a
quarantine shows up as lost capacity and can trigger a scale-up — the
fleet heals around a sick device instead of waiting for it.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class QuarantinePolicy:
    """Strike thresholds and timing for :class:`QuarantineBoard`.

    ``threshold`` strikes within ``window`` seconds quarantine a device
    for ``duration`` seconds; re-admission requires ``probation_trials``
    clean completions.
    """
    threshold: int = 3
    window: float = 60.0
    duration: float = 120.0
    probation_trials: int = 2

    def __post_init__(self):
        if self.threshold < 1:
            raise ValueError(
                f"threshold must be >= 1, got {self.threshold}")
        if self.window <= 0:
            raise ValueError(f"window must be positive, got {self.window}")
        if self.duration <= 0:
            raise ValueError(
                f"duration must be positive, got {self.duration}")
        if self.probation_trials < 1:
            raise ValueError(
                f"probation_trials must be >= 1, got {self.probation_trials}")


class QuarantineBoard:
    """Per-device strike scoreboard with quarantine and probation.

    States per device: ``"healthy"`` (default), ``"quarantined"`` (not
    launchable), ``"probation"`` (launchable, under observation).  The
    engine drives transitions: :meth:`strike` on timeout/failure,
    :meth:`begin_probation` when the quarantine timer fires,
    :meth:`on_success` on clean trial completion, :meth:`retire` when the
    device leaves the fleet.
    """

    def __init__(self, policy: QuarantinePolicy | None = None):
        self.policy = policy or QuarantinePolicy()
        self._strikes: dict[int, list[float]] = {}
        self._state: dict[int, str] = {}
        self._ok: dict[int, int] = {}
        self._counts: dict[int, int] = {}
        self.total_quarantines = 0

    def state(self, device: int) -> str:
        return self._state.get(device, "healthy")

    def is_quarantined(self, device: int) -> bool:
        return self._state.get(device) == "quarantined"

    def quarantined_now(self) -> int:
        return sum(1 for s in self._state.values() if s == "quarantined")

    def quarantine_count(self, device: int) -> int:
        """How many times this device has ever been quarantined."""
        return self._counts.get(device, 0)

    def _quarantine(self, device: int) -> None:
        self._state[device] = "quarantined"
        self._strikes.pop(device, None)
        self._ok[device] = 0
        self._counts[device] = self._counts.get(device, 0) + 1
        self.total_quarantines += 1

    def strike(self, device: int, t: float) -> bool:
        """Record one strike at sim-time ``t``.  Returns True iff the
        device *newly* entered quarantine (strikes while already
        quarantined are ignored; any strike during probation is an
        immediate re-quarantine — the flap)."""
        state = self._state.get(device, "healthy")
        if state == "quarantined":
            return False
        if state == "probation":
            self._quarantine(device)
            return True
        times = self._strikes.setdefault(device, [])
        times.append(float(t))
        lo = float(t) - self.policy.window
        while times and times[0] < lo:
            times.pop(0)
        if len(times) >= self.policy.threshold:
            self._quarantine(device)
            return True
        return False

    def begin_probation(self, device: int) -> None:
        """Quarantine timer fired: re-admit under observation."""
        self._state[device] = "probation"
        self._ok[device] = 0

    def on_success(self, device: int) -> None:
        """Clean trial completion; only probation cares."""
        if self._state.get(device) != "probation":
            return
        self._ok[device] = self._ok.get(device, 0) + 1
        if self._ok[device] >= self.policy.probation_trials:
            self._state.pop(device, None)
            self._ok.pop(device, None)
            self._strikes.pop(device, None)

    def retire(self, device: int) -> None:
        """Device left the fleet — drop all its entries so
        ``quarantined_now()`` never counts capacity that no longer
        exists."""
        self._strikes.pop(device, None)
        self._state.pop(device, None)
        self._ok.pop(device, None)

    # ---- crash-recovery persistence ----------------------------------

    def state_dict(self) -> dict:
        return {
            "strikes": [[d, list(ts)] for d, ts
                        in sorted(self._strikes.items())],
            "state": [[d, s] for d, s in sorted(self._state.items())],
            "ok": [[d, n] for d, n in sorted(self._ok.items())],
            "counts": [[d, n] for d, n in sorted(self._counts.items())],
            "total_quarantines": self.total_quarantines,
        }

    def load_state(self, state: dict) -> None:
        self._strikes = {int(d): [float(t) for t in ts]
                         for d, ts in state.get("strikes", [])}
        self._state = {int(d): str(s) for d, s in state.get("state", [])}
        self._ok = {int(d): int(n) for d, n in state.get("ok", [])}
        self._counts = {int(d): int(n) for d, n in state.get("counts", [])}
        self.total_quarantines = int(state.get("total_quarantines", 0))


__all__ = ["QuarantineBoard", "QuarantinePolicy"]
