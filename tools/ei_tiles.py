#!/usr/bin/env python3
"""Times the EIrate and class-axis EIrate kernels against variants of their
tile, alone, at the main paths' shapes, on one CUDA card.

    python3 tools/ei_tiles.py [ROUNDS]

Each variant is the tree's ``kernels/csrc`` with a few lines of
``ei_column.cuh`` replaced (``VARIANTS``), built with the kernels' flags into
``build/ei_tiles/``; ``tree`` is the sources as they are.  The inputs are
made from a seed as ``chip_smoke.py`` makes them, disjoint membership:

  fig5          N 50, n 2,500: the Fig-5 episode's EIrate pass
  device_churn  N 256, n 4,096, C 1: device churn run (a)'s class-axis pass
  service       N 1,000, n 100,000, C 4

Every variant's scores must be bit-equal to the tree's.  ROUNDS rounds
(default 6) time each (shape, kernel, variant) under torch.profiler
(``chip_smoke.device_ms``, 200 launches), the variants in turn, forward in
even rounds and backward in odd ones; one JSON line a (shape, kernel):
each variant's median, least and largest mean over the rounds.  Then the
card's name and power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch import _build  # noqa: E402

#: name -> (old, new) replacements in ei_column.cuh
VARIANTS = {
    "tree": [],
    # 16-column tiles: twice the blocks
    "cols16": [("constexpr int kTileCols = 32;", "constexpr int kTileCols = 16;")],
    # byte row loads where n is a multiple of 4 but not of 16
    "vec1": [("  else if (n % 4 == 0 && base % 4 == 0) launch(RowLoad<4>{});\n", "")],
}
SHAPES = {"fig5": (50, 2500, 1), "device_churn": (256, 4096, 1),
          "service": (1000, 100_000, 4)}
KERNELS = {"ei_score": ("eirate_launch", "eirate_kernel"),
           "ei_classes": ("eirate_classes_launch", "eirate_classes_kernel")}


def build(name: str, patches) -> dict:
    """The variant's two libraries, built (in parallel) unless present."""
    header = (_build.SRC_DIR / "ei_column.cuh").read_text()
    for old, new in patches:
        if header.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in ei_column.cuh once")
        header = header.replace(old, new)
    h = hashlib.sha256(header.encode())
    for src in KERNELS:
        h.update((_build.SRC_DIR / f"{src}.cu").read_bytes())
    work = ROOT / "build" / "ei_tiles" / f"{name}-{h.hexdigest()[:16]}"
    work.mkdir(parents=True, exist_ok=True)
    (work / "ei_column.cuh").write_text(header)
    procs = {}
    for src in KERNELS:
        lib = work / f"lib{src}.so"
        if not lib.exists():
            shutil.copy(_build.SRC_DIR / f"{src}.cu", work / f"{src}.cu")
            procs[src] = subprocess.Popen(
                [_build._nvcc(), *_build.flags(src), "-o", str(lib),
                 str(work / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for src, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: {src}.cu failed:\n{log}")
    libs = {}
    for src, (entry, _) in KERNELS.items():
        fn = getattr(ctypes.CDLL(str(work / f"lib{src}.so")), entry)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * (
            2 if src == "ei_score" else 3) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[src] = fn
    return libs


def launcher(fn, src, args, cm, out):
    mu, sg, best, mem, cost, sel = args
    N, n = mem.shape
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (mu, sg, best, mem)]
    if src == "ei_score":
        tail = (cost.data_ptr(), sel.data_ptr(), out.data_ptr(), N, n, stream)
    else:
        tail = (cm.data_ptr(), sel.data_ptr(), out.data_ptr(), N, n,
                cm.shape[0], stream)

    def launch():
        err = fn(*ptrs, *tail)
        if err != 0:
            raise RuntimeError(f"{src} launch failed: cudaError {err}")
    return launch


def main() -> int:
    if not torch.cuda.is_available():
        print("ei_tiles: no CUDA device is available", file=sys.stderr)
        return 2
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    dev = torch.device("cuda")
    libs = {name: build(name, patches) for name, patches in VARIANTS.items()}
    rng = np.random.default_rng(0)
    for shape, (N, n, C) in SHAPES.items():
        args = chip_smoke.ei_inputs(N, n, "disjoint", rng, dev)
        cm = torch.stack([args[4] * (c + 1) for c in range(C)])
        for src, (_, kernel) in KERNELS.items():
            outs = {v: torch.empty(n if src == "ei_score" else C * n,
                                   dtype=torch.float32, device=dev)
                    for v in VARIANTS}
            calls = {v: launcher(libs[v][src], src, args, cm, outs[v])
                     for v in VARIANTS}
            for v, call in calls.items():
                call()
            torch.cuda.synchronize()
            chip_smoke.check(all(torch.equal(outs[v], outs["tree"]) for v in VARIANTS),
                             f"ei_tiles {shape} {src}: a variant differs from the tree")
            times = {v: [] for v in VARIANTS}
            order = list(VARIANTS)
            for r in range(rounds):
                for v in (order if r % 2 == 0 else order[::-1]):
                    times[v].append(chip_smoke.device_ms(calls[v], kernel, 200))
            print(json.dumps(dict(
                shape=shape, N=N, n=n, C=C, kernel=src, rounds=rounds,
                ms={v: dict(median=statistics.median(t), least=min(t), largest=max(t))
                    for v, t in times.items()},
                median_over_tree={v: statistics.median(t) / statistics.median(times["tree"])
                                  for v, t in times.items()})), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
