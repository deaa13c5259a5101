#!/usr/bin/env python3
"""``chip_smoke.py``'s ``launch`` phase alone, then ``tools/bar_noise.py``.

    python3 tools/launch_phase.py [REPEATS]

Runs the phase as ``chip_smoke.py`` does (its dry-run processes started
just before it), prints its JSON line and writes it to
``chiprun_out/launch_phase.json``, then runs ``tools/bar_noise.py
REPEATS`` (default 16) and prints its output, and the card's name and
power limit as ``nvidia-smi`` reports them.  Needs one CUDA card; builds
no kernel (the phase launches none).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ei_score, gp_readout
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ssd as ssd_mod

    repeats = sys.argv[1] if len(sys.argv) > 1 else "16"
    counters = {"eirate": (ei_score, "launches"),
                "eirate_topk": (ei_score, "topk_launches"),
                "eirate_classes": (ei_score, "classes_launches"),
                "gp_readout": (gp_readout, "launches"),
                "flash_attention": (flash_mod, "launches"), "ssd": (ssd_mod, "launches")}
    procs = cs._start_dryrun_cells()
    try:
        rec = cs.launch_phase(torch.device("cuda"), counters, procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    cs.emit(rec)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "launch_phase.json").write_text(json.dumps(rec, indent=1))
    p = subprocess.run([sys.executable, str(ROOT / "tools" / "bar_noise.py"), repeats],
                       capture_output=True, text=True)
    print(p.stdout, flush=True)
    print(cs.card_name_and_power(), flush=True)
    return p.returncode


if __name__ == "__main__":
    sys.exit(main())
