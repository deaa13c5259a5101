#!/usr/bin/env python3
"""Times the SSD scan's two routes kernel by kernel, on one CUDA card.

    python3 tools/ssd_profile.py

Builds ``csrc/ssd_sm90.cu`` and ``csrc/ssd.cu`` (``_build``), then at
mamba2-1.3b's layer shape (B 4, S 2,048, H 64, P 64, N 128, chunk 256) and
zamba2-2.7b's (H 80, N 64) with bf16 x, b and c (the tensor-core route),
and at B 2 of both, a single chunk (B 2, S 256) and serve's float32 check
(B 1, S 513, one chunk of 513) with float32 x, b and c (the tf32x3 route),
inputs made from a seed as ``chip_smoke.py`` makes them: holds each call
to ``ref.ssd_ref`` at ``chip_smoke.py``'s float32 tolerance and prints one
JSON line per case: CUDA-event ms per call, and each of the route's
kernels' mean device ms under torch.profiler.  Then the card's name and
power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd as ssd_mod  # noqa: E402

CASES = (("mamba2_1p3b", 4, 2048, 64, 64, 128, 256, torch.bfloat16),
         ("zamba2_2p7b", 4, 2048, 80, 64, 64, 256, torch.bfloat16),
         ("mamba2_1p3b_f32", 2, 2048, 64, 64, 128, 256, torch.float32),
         ("zamba2_2p7b_f32", 2, 2048, 80, 64, 64, 256, torch.float32),
         ("single_chunk_f32", 2, 256, 64, 64, 128, 256, torch.float32),
         ("serve_check_f32", 1, 513, 64, 64, 128, 513, torch.float32))


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_profile: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, B, S, H, P, N, chunk, dtype in CASES:
        x = torch.randn((B, S, H, P), generator=gen, device=dev).to(dtype)
        dt = torch.rand((B, S, H), generator=gen, device=dev) * 0.099 + 0.001
        la = -dt * (torch.rand((H,), generator=gen, device=dev) * 1.5 + 0.5)
        b, c = (torch.randn((B, S, N), generator=gen, device=dev).to(dtype)
                for _ in range(2))

        def call():
            return ssd_mod.ssd_mix(x, dt, la, b, c, chunk=chunk)

        route = ssd_mod.route(dtype)
        agreement = chip_smoke.held(f"ssd {name}", call(), ref.ssd_ref(x, dt, la, b, c))
        parts: dict[str, float] = {}
        kernel_ms = chip_smoke.device_ms(call, ssd_mod.call_kernels(route, S, chunk), 20,
                                         parts)
        print(json.dumps(dict(case=name, route=route, B=B, S=S, H=H, P=P, N=N,
                              chunk=chunk, ms=chip_smoke.cuda_ms(call, 50),
                              kernel_ms=kernel_ms, kernel_ms_by_kernel=parts,
                              max_abs_err=agreement["max_abs_err"],
                              err_over_max_abs_want=agreement["err_over_max_abs_want"])),
              flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
