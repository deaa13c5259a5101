"""Roofline-derived trial cost c(x) on H100s: the paper's Remark 1 made concrete.

The port's copy of ``repro.core.cost_model``, with the H100's peaks in
place of the reference's hardware table.  The paper assumes run cost c(x)
is "easy to estimate [from] the dataset size, the computational hardware
parameters, historical data".  Here that estimate is the roofline: for a
trial = (arch config, input shape, slice of `chips` cards, `steps` steps),

  c(x) = steps * max(compute_term, memory_term, collective_term)

with the three terms taken from a probe JSON when one exists for the
(arch, shape) cell, else from an analytic model on the constants below.  A
measured-update hook blends in observed durations (historical data), which
the service uses after every completed trial.

The probe path reads the reference's file layout under the port's own
directory, ``DRYRUN_DIR/<mesh>/<arch>__<shape>__<rules>__probe.json``
(``experiments/dryrun_torch``, so that a TPU record is never read as a
card's), each file the per-card compute, memory and collective seconds of
one step on a slice of ``REFERENCE_CHIPS`` cards named by ``mesh`` (256,
"pod16x16"), counted against the constants below by
``python -m repro_torch.launch.dryrun --probe``.  Without the file a cell
takes the analytic path.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

# One NVIDIA H100 SXM (NVIDIA's data sheet; dense rates, no sparsity), the
# peaks chip_smoke.py and PERF.md hold the kernels to
PEAK_FLOPS = 989e12       # bf16 FLOP/s a card, tensor cores
HBM_BW = 3.35e12          # HBM3 bytes/s a card
ICI_BW = 450e9            # NVLink 4 bytes/s a card, one direction (900e9 both)
HBM_PER_CHIP = 80e9       # HBM3 capacity of a card, bytes

DRYRUN_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
REFERENCE_CHIPS = 256     # cards of the slice a probe was taken on


@dataclass
class CostModel:
    mfu_assumption: float = 0.4      # analytic-path efficiency guess
    measured_blend: float = 0.5      # EMA weight for observed durations
    _measured: dict = field(default_factory=dict)
    _probe_cache: dict = field(default_factory=dict)

    # -- probe-backed path ---------------------------------------------------

    def _probe(self, arch: str, shape: str, mesh: str = "pod16x16",
               rules: str = "default"):
        key = (arch, shape, mesh, rules)
        if key not in self._probe_cache:
            path = DRYRUN_DIR / mesh / f"{arch}__{shape}__{rules}__probe.json"
            self._probe_cache[key] = json.loads(path.read_text()) if path.exists() else None
        return self._probe_cache[key]

    def step_seconds(self, arch: str, shape: str, chips: int = REFERENCE_CHIPS,
                     cfg=None) -> float:
        """Roofline step time for one (arch, shape) on a `chips`-card slice."""
        probe = self._probe(arch, shape)
        if probe is not None:
            scale = REFERENCE_CHIPS / max(chips, 1)   # fewer cards => more per-card work
            return max(probe["compute_seconds"], probe["memory_seconds"],
                       probe["collective_seconds"]) * scale
        if cfg is None:
            from ..configs import get_config
            cfg = get_config(arch)
        return self._analytic(cfg, shape, chips)

    def _analytic(self, cfg, shape: str, chips: int) -> float:
        from ..configs import SHAPES
        S, B, kind = SHAPES[shape]
        n_active = cfg.active_param_count()
        factor = 6.0 if kind == "train" else 2.0
        tokens = S * B if kind in ("train", "prefill") else B
        compute = factor * n_active * tokens / (chips * PEAK_FLOPS * self.mfu_assumption)
        # memory term: params + optimizer traffic per step
        param_bytes = cfg.param_count() * 4.0 * (3.0 if kind == "train" else 0.5)
        memory = param_bytes / (chips * HBM_BW)
        return max(compute, memory)

    # -- trial-level costs ---------------------------------------------------

    def trial_seconds(self, arch: str, shape: str, steps: int,
                      chips: int = REFERENCE_CHIPS, overhead: float = 30.0,
                      cfg=None) -> float:
        """c(x) for a `steps`-step trial (+ fixed setup/compile overhead)."""
        key = (arch, shape, chips)
        est = overhead + steps * self.step_seconds(arch, shape, chips, cfg)
        if key in self._measured:
            est = (1 - self.measured_blend) * est + self.measured_blend * self._measured[key]
        return est

    def class_trial_seconds(self, arch: str, shape: str, steps: int, *,
                            chips: int, speed: float = 1.0,
                            overhead: float = 30.0, cfg=None) -> float:
        """c(x, d): the Remark-1 estimate specialized to one device class
        (``repro_torch.devplane.DeviceClass``): the roofline step time at
        the class's card count, scaled by the class's clock-speed
        multiplier, plus the fixed per-trial overhead.  The overhead does
        not scale with speed (setup/compile is host-bound), which is what
        makes the (device-class x model) cost matrix genuinely 2-D: an
        affine map of the base cost, not the rank-1 ``c(x)/speed_d``."""
        if speed <= 0:
            raise ValueError(f"speed must be positive, got {speed}")
        return overhead + steps * self.step_seconds(arch, shape, chips, cfg) / speed

    def observe(self, arch: str, shape: str, chips: int, measured_seconds: float):
        """Historical-data update (Remark 1): EMA of observed trial durations."""
        key = (arch, shape, chips)
        prev = self._measured.get(key, measured_seconds)
        self._measured[key] = 0.5 * prev + 0.5 * measured_seconds
