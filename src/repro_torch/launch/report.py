"""Render the dry-run tables from the port's dry-run and probe JSON records.

Counterpart of ``repro.launch.report``, over
``experiments/dryrun_torch/<mesh>/`` (``repro_torch.launch.dryrun``):

  PYTHONPATH=src python -m repro_torch.launch.report
"""

from __future__ import annotations

import json
from pathlib import Path

from ..core.cost_model import DRYRUN_DIR as ROOT


def fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB", "PB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}EB"


def _records(mesh: str, probe: bool, root: Path | None = None):
    root = ROOT if root is None else root
    suffix = "__probe.json" if probe else ".json"
    out = {}
    for p in sorted((root / mesh).glob(f"*{suffix}")):
        if probe != p.name.endswith("__probe.json"):
            continue
        parts = p.name.replace("__probe.json", "").replace(".json", "").split("__")
        if len(parts) != 3:
            continue   # tagged perf-iteration snapshots are skipped
        arch, shape, rules = parts
        out[(arch, shape, rules)] = json.loads(p.read_text())
    return out


def dryrun_table(mesh: str, root: Path | None = None) -> str:
    recs = _records(mesh, probe=False, root=root)
    lines = [
        f"#### Mesh `{mesh}` — dry-run traces",
        "",
        "| arch | shape | rules | kind | trace (s) | args/dev | temp/dev | fits 80GB | collectives |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape, rules), r in sorted(recs.items()):
        ms = r["memory_stats"]
        colls = ",".join(f"{k}:{v}" for k, v in sorted(r.get("collectives", {}).items())) or "-"
        lines.append(
            f"| {arch} | {shape} | {rules} | {r.get('kind','?')} "
            f"| {r.get('trace_seconds','?')} "
            f"| {fmt_bytes(ms['argument_bytes'])} | {fmt_bytes(ms['temp_bytes'])} "
            f"| {'yes' if r.get('fits_hbm') else 'NO'} | {colls} |")
    return "\n".join(lines)


def roofline_table(mesh: str = "pod16x16", rules: str | None = None,
                   root: Path | None = None) -> str:
    recs = _records(mesh, probe=True, root=root)
    lines = [
        f"#### Mesh `{mesh}` — roofline terms (per step, full-depth traces, H100)",
        "",
        "| arch | shape | rules | compute (ms) | memory (ms) | collective (ms) | dominant "
        "| model GFLOPs | useful (6ND/counted) | wire bytes/dev |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape, rl), r in sorted(recs.items()):
        if rules is not None and rl != rules:
            continue
        lines.append(
            f"| {arch} | {shape} | {rl} "
            f"| {r['compute_seconds']*1e3:.1f} | {r['memory_seconds']*1e3:.1f} "
            f"| {r['collective_seconds']*1e3:.1f} | **{r['dominant']}** "
            f"| {r['model_flops_global']/1e9:,.0f} | {r['useful_flops_ratio']:.3f} "
            f"| {fmt_bytes(r['collective_wire_bytes'])} |")
    return "\n".join(lines)


def main() -> None:
    for mesh in ("pod16x16", "pod2x16x16"):
        if (ROOT / mesh).exists():
            print(dryrun_table(mesh))
            print()
    print(roofline_table("pod16x16"))


if __name__ == "__main__":
    main()
