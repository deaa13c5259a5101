"""Builds the CUDA sources of ``kernels/csrc/`` with ``nvcc`` at first use.

Each ``<name>.cu`` becomes its own shared library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).  The
libraries go to ``build/repro_torch/`` at the root of the checkout, named
by a hash of the source, the shared headers and its flags, so a second run
reuses them and an edited source is rebuilt.  Sources that need a build
are compiled by one ``nvcc`` process each, all started together.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "kernels" / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: sources held to a tolerance, not to bits, against their plain versions:
#: they may contract multiply-adds.  Every other source is built with
#: -fmad=false, so each product and sum rounds on its own exactly as the
#: plain PyTorch versions' separate ops do (the EIrate kernels and the
#: readout are held bit-equal).
FMA_SOURCES = frozenset({"flash_attention", "flash_attention_sm90", "ssd"})

#: ``nvcc`` output (``-Xptxas -v``: registers, spills) of this process's builds
BUILD_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernels cannot "
                           "be built")
    return path


def flags(name: str) -> tuple[str, ...]:
    """The nvcc flags of ``csrc/<name>.cu``."""
    return NVCC_FLAGS if name in FMA_SOURCES else (*NVCC_FLAGS, "-fmad=false")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(flags(name)).encode())
    h.update((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, float]:
    """Compile every named source (default: all) whose library is missing.
    Returns the seconds each build took; a reused library reports 0."""
    names = sources() if names is None else names
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags(name), "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
