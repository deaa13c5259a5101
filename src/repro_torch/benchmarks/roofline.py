"""Roofline report: one row per (arch x shape) dry-run probe.

Counterpart of the JAX package's ``benchmarks/roofline.py``.  Reads the
probe JSONs that ``repro_torch.launch.dryrun --probe`` writes (full-depth
counts of one rank of the 16 x 16 mesh, against one H100's peaks) and the
plain dry-run records beside them (fits-HBM).  ``us_per_call`` is the
roofline-predicted step time (max of the three terms) in microseconds."""

from __future__ import annotations

import json

from ..core import cost_model
from .common import emit


def load(mesh: str, name: str) -> dict | None:
    p = cost_model.DRYRUN_DIR / mesh / name
    return json.loads(p.read_text()) if p.exists() else None


def main() -> None:
    root = cost_model.DRYRUN_DIR
    mesh = "pod16x16"
    probe_files = sorted((root / mesh).glob("*__probe.json")) if (root / mesh).exists() else []
    if not probe_files:
        emit("roofline_missing", 0.0,
             note="run repro_torch.launch.dryrun --probe first")
        return
    for pf in probe_files:
        rec = json.loads(pf.read_text())
        arch, shape, rules = pf.stem.split("__")[:3]
        scan = load(mesh, f"{arch}__{shape}__{rules}.json") or {}
        step_s = max(rec["compute_seconds"], rec["memory_seconds"],
                     rec["collective_seconds"])
        emit(f"roofline_{arch}_{shape}_{rules}", step_s * 1e6,
             dominant=rec["dominant"],
             compute_ms=f"{rec['compute_seconds']*1e3:.2f}",
             memory_ms=f"{rec['memory_seconds']*1e3:.2f}",
             collective_ms=f"{rec['collective_seconds']*1e3:.2f}",
             useful_flops=f"{rec['useful_flops_ratio']:.3f}",
             fits_hbm=scan.get("fits_hbm", rec.get("fits_hbm", "n/a")))


if __name__ == "__main__":
    main()
