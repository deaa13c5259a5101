#!/usr/bin/env python3
"""Times the data plane's kernels built with and without multiply-add
contraction, on one CUDA card.

    python3 tools/fmad_ab.py

Builds ``csrc/flash_attention.cu`` (the float32 route),
``csrc/flash_attention_sm90.cu`` (the bf16 wgmma route), ``csrc/ssd.cu``
(the SSD scan's float32 route) and ``csrc/ssd_sm90.cu`` (its bf16
tensor-core route) twice into ``build/repro_torch/fmad_ab/``: with ``_build.NVCC_FLAGS`` (nvcc
contracts a multiply and an add into one FMA where it can) and with
``-fmad=false`` added (each product and sum rounds on its own, as the
EIrate kernels are built).  Each build is held against the plain version
and timed with CUDA events at qwen3-4b's layer shape (B 4, S 2,048, Hq 32,
Hkv 8, D 128; float32 for the tf32x3 route, bf16 for the wgmma route)
and mamba2-1.3b's (B 4, S 2,048, H 64, P 64, N 128, chunk 256; x, b, c
float32 for the CUDA-core route, bf16 for the tensor-core route), the two
builds alternating (fma, no_fma, no_fma, fma) over ``ROUNDS``
rounds.  Prints one JSON line per kernel, then the card's name and power
limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import _build  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd as ssd_mod  # noqa: E402

OUT = _build.BUILD_DIR / "fmad_ab"
SOURCES = ("flash_attention", "flash_attention_sm90", "ssd", "ssd_sm90")
VARIANTS = {"fma": _build.NVCC_FLAGS, "no_fma": (*_build.NVCC_FLAGS, "-fmad=false")}
ROUNDS = 3


def build_all() -> dict[tuple[str, str], ctypes.CDLL]:
    """Every (source, variant) library, compiled by one nvcc each, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        for variant, flags in VARIANTS.items():
            out = OUT / f"lib{name}-{variant}.so"
            cmd = [_build._nvcc(), *flags, "-o", str(out),
                   str(_build.SRC_DIR / f"{name}.cu")]
            procs[name, variant] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for key, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(out))
    return libs


def use(name: str, lib: ctypes.CDLL) -> None:
    """Points the wrapper of ``name`` at ``lib``."""
    _build._LIBS[name] = lib
    loaders = {"flash_attention": flash_mod._launcher,
               "flash_attention_sm90": flash_mod._launcher,
               "ssd": ssd_mod._lib, "ssd_sm90": ssd_mod._sm90}
    loaders[name].cache_clear()


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("fmad_ab: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((4, 2048, h, 128), generator=gen, device=dev)
               for h in (32, 8, 8))
    q16, k16, v16 = (t.bfloat16() for t in (q, k, v))
    x = torch.randn((4, 2048, 64, 64), generator=gen, device=dev)
    dt = torch.rand((4, 2048, 64), generator=gen, device=dev) * 0.099 + 0.001
    la = -dt * (torch.rand((64,), generator=gen, device=dev) * 1.5 + 0.5)
    b, c = (torch.randn((4, 2048, 128), generator=gen, device=dev) for _ in range(2))
    x16, b16, c16 = (t.bfloat16() for t in (x, b, c))
    cases = {
        "flash_attention": (lambda: flash_mod.flash_attention(q, k, v),
                            ref.attention_ref(q, k, v), 10),
        "flash_attention_sm90": (lambda: flash_mod.flash_attention(q16, k16, v16),
                                 ref.attention_ref(q16, k16, v16).float(), 50),
        "ssd": (lambda: ssd_mod.ssd_mix(x, dt, la, b, c, chunk=256),
                ref.ssd_ref(x, dt, la, b, c), 10),
        "ssd_sm90": (lambda: ssd_mod.ssd_mix(x16, dt, la, b16, c16, chunk=256),
                     ref.ssd_ref(x16, dt, la, b16, c16), 50),
    }
    order = ["fma", "no_fma", "no_fma", "fma"]
    for name, (fn, want, iters) in cases.items():
        times = {variant: [] for variant in VARIANTS}
        errs = {}
        for _ in range(ROUNDS):
            for variant in order:
                use(name, libs[name, variant])
                errs[variant] = float((fn().float() - want).abs().max())
                times[variant].append(cuda_ms(fn, iters))
        means = {variant: sum(t) / len(t) for variant, t in times.items()}
        print(json.dumps(dict(kernel=name, ms=times, mean_ms=means,
                              no_fma_over_fma=means["no_fma"] / means["fma"],
                              max_abs_err_vs_plain=errs,
                              max_abs_want=float(want.abs().max()))), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
