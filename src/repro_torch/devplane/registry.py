"""Device-class registry: the heterogeneous half of the elastic device plane.

The paper treats the M devices as identical; a real provider's fleet mixes
generations and slice sizes (the multi-cloud model-search line of work shows
the *hardware class* changes which candidate wins).  A :class:`DeviceClass`
names one such class — chips per slice, a clock-speed multiplier vs the
reference slice, an optional memory capacity, and a fixed per-trial
``overhead`` (setup/compile seconds that do NOT shrink on a faster chip).

Cost routing (DESIGN.md §11): class c's trial cost for a model with base
cost ``c(x)`` (measured on the reference slice) is

    cost(c, x) = overhead_c + c(x) / rate_c,      rate_c = speed * chips/ref

an *affine* map per class.  With ``overhead > 0`` the (class x model) cost
matrix is genuinely 2-D — no ``speed_d`` vector factorizes it — which is
what makes the joint (device, model) assignment a real 2-D problem instead
of k independent argmaxes over a shared ranking.  For data-plane-backed
models, :meth:`DeviceClass.from_cost_model` calibrates ``rate`` from any
object with a ``class_trial_seconds`` method (the roofline
``repro_torch.core.cost_model.CostModel``, on the H100's peaks) instead of
the nominal chip ratio.

The port's copy of ``repro.devplane.registry`` (numpy only).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.fleet import DEFAULT_CLASS, DeviceSlice, Fleet

REFERENCE_CHIPS = 16     # chips of the "rate 1.0" reference slice


@dataclass(frozen=True)
class DeviceClass:
    """One hardware class: what a slice of it costs per trial."""
    name: str
    chips: int = REFERENCE_CHIPS
    speed: float = 1.0              # clock multiplier vs the reference slice
    overhead: float = 0.0           # fixed per-trial seconds (host-bound)
    mem_gb: float | None = None     # slice HBM; None = unconstrained
    chip_scale: float | None = None  # throughput factor from chip count;
                                     # None = nominal chips/REFERENCE_CHIPS

    def __post_init__(self):
        if self.speed <= 0:
            raise ValueError(f"speed must be positive, got {self.speed}")
        if self.overhead < 0:
            raise ValueError(f"overhead must be >= 0, got {self.overhead}")

    @property
    def rate(self) -> float:
        """Effective throughput multiplier vs the reference slice."""
        scale = (self.chips / REFERENCE_CHIPS if self.chip_scale is None
                 else self.chip_scale)
        return self.speed * scale

    def cost_on(self, base_cost) -> np.ndarray:
        """c(x, d) for this class, vectorized over base costs."""
        return self.overhead + np.asarray(base_cost, dtype=float) / self.rate

    def fits(self, model_mem_gb: float | None) -> bool:
        """Memory gate: can a model with this HBM footprint run here?"""
        return (self.mem_gb is None or model_mem_gb is None
                or model_mem_gb <= self.mem_gb)

    @classmethod
    def from_cost_model(cls, name: str, cost_model, arch: str, shape: str,
                        steps: int, *, chips: int, speed: float = 1.0,
                        overhead: float = 30.0, mem_gb: float | None = None,
                        cfg=None) -> "DeviceClass":
        """Calibrate the class against the roofline: ``chip_scale`` is the
        measured step-time ratio reference-slice/this-slice for the given
        (arch, shape) cell — exact when the roofline is linear in chips,
        and still right when a probe says otherwise."""
        ref = cost_model.class_trial_seconds(
            arch, shape, steps, chips=REFERENCE_CHIPS, speed=1.0,
            overhead=0.0, cfg=cfg)
        here = cost_model.class_trial_seconds(
            arch, shape, steps, chips=chips, speed=1.0, overhead=0.0, cfg=cfg)
        return cls(name=name, chips=chips, speed=speed, overhead=overhead,
                   mem_gb=mem_gb, chip_scale=ref / here)


BASE_CLASS = DeviceClass(DEFAULT_CLASS)


class DeviceClassRegistry:
    """Name -> :class:`DeviceClass`, plus the cost-matrix/fleet factories
    the elastic engine consumes."""

    def __init__(self, classes=()):
        self._classes: dict[str, DeviceClass] = {}
        for c in classes:
            self.register(c)

    def register(self, cls: DeviceClass) -> DeviceClass:
        if cls.name in self._classes:
            raise ValueError(f"device class {cls.name!r} already registered")
        self._classes[cls.name] = cls
        return cls

    def __getitem__(self, name: str) -> DeviceClass:
        try:
            return self._classes[name]
        except KeyError:
            raise KeyError(f"unknown device class {name!r}; "
                           f"registered: {sorted(self._classes)}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._classes

    def __len__(self) -> int:
        return len(self._classes)

    @property
    def names(self) -> list[str]:
        return sorted(self._classes)

    def rows(self, names) -> tuple[np.ndarray, np.ndarray]:
        """(rates, overheads) float32 rows for ``choose_mdmt_batch`` — one
        entry per name, order preserved."""
        rates = np.asarray([self[n].rate for n in names], np.float32)
        overheads = np.asarray([self[n].overhead for n in names], np.float32)
        return rates, overheads

    def cost_matrix(self, base_cost, names=None,
                    model_mem_gb=None) -> np.ndarray:
        """(C, n) per-class trial costs for base costs ``c(x)``; models that
        do not fit a class's memory get +inf there — which the dense class
        scorer (``ei.eirate_class_scores``) turns into a hard -inf
        exclusion.  The streaming engine does not consume the gate (its
        tenant blocks carry no per-model footprint); it serves explicit
        cost-matrix consumers such as offline assignment analysis."""
        names = self.names if names is None else list(names)
        base = np.asarray(base_cost, dtype=float)
        out = np.stack([self[n].cost_on(base) for n in names])
        if model_mem_gb is not None:
            mem = np.asarray(model_mem_gb, dtype=float)
            for i, n in enumerate(names):
                cap = self[n].mem_gb
                if cap is not None:
                    out[i, mem > cap] = np.inf
        return out

    def build_fleet(self, counts) -> Fleet:
        """A Fleet from ``[(class_name, count), ...]`` (or a dict): slice
        ids are assigned in iteration order, ``speed`` is the class's
        effective rate, ``cls`` the class name."""
        items = counts.items() if isinstance(counts, dict) else counts
        slices = []
        for name, count in items:
            c = self[name]
            for _ in range(count):
                slices.append(DeviceSlice(
                    len(slices), c.chips, c.rate, cls=name))
        return Fleet(slices)

    @classmethod
    def from_fleet(cls, fleet: Fleet) -> "DeviceClassRegistry":
        """Synthesize a registry from an existing fleet: one zero-overhead
        class per distinct ``cls`` name (rank-1 costs — the backward-
        compatible default when no registry is supplied)."""
        reg = cls()
        for s in fleet.slices:
            if s.cls in reg:
                if reg[s.cls].rate != s.speed:
                    raise ValueError(
                        f"slices of class {s.cls!r} disagree on speed; "
                        "register explicit DeviceClasses instead")
                continue
            reg.register(DeviceClass(
                name=s.cls, chips=s.chips, speed=s.speed, chip_scale=1.0))
        return reg


def two_class_registry(fast_speed: float = 2.0, *, overhead: float = 0.0,
                       chips: int = REFERENCE_CHIPS) -> DeviceClassRegistry:
    """The benchmark/test fixture: a ``slow`` reference class and a ``fast``
    class at ``fast_speed``x, optionally with a per-trial overhead (making
    the cost matrix genuinely 2-D)."""
    return DeviceClassRegistry([
        DeviceClass("slow", chips=chips, speed=1.0, overhead=overhead,
                    chip_scale=1.0),
        DeviceClass("fast", chips=chips, speed=fast_speed, overhead=overhead,
                    chip_scale=1.0),
    ])


__all__ = ["DeviceClass", "DeviceClassRegistry", "BASE_CLASS",
           "REFERENCE_CHIPS", "two_class_registry"]
