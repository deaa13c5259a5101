"""Mamba2 SSD chunk scan: the CUDA kernel's wrapper.

Counterpart of ``repro.kernels.ssd.ssd_pallas``.  The kernel
(``csrc/ssd.cu``) runs one block per (batch * head) that walks the chunks
in order with the (P x N) state in shared memory and folds dt into x as it
loads it; its plain version is ``ref.ssd_ref``, the per-step recurrence.
It takes any sequence length (the last chunk may be short).
``ops.ssd_mix`` sends CPU tensors to the plain version and CUDA tensors
here, where they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

#: kernel launches since the last reset (launches only, never the CPU path)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
SMEM_LIMIT = 232_448          # bytes of shared memory a block may use (H100)


@functools.cache
def _lib():
    from .. import _build
    lib = _build.load("ssd")
    lib.ssd_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 13
        + [ctypes.c_void_p])
    lib.ssd_launch.restype = ctypes.c_int
    lib.ssd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.ssd_smem_bytes.restype = ctypes.c_longlong
    return lib


def ssd_mix(x, dt, log_a, b, c, *, chunk: int = 256):
    """The SSD mix y (B, S, H, P) float32 (without the D * x skip term),
    from the kernel, in chunks of ``min(chunk, S)`` steps.

    x (B, S, H, P) and b/c (B, S, N), all float32 or all bfloat16; dt and
    log_a (B, S, H) float32; all on one CUDA device, unit stride along the
    last axis.  P <= 128."""
    global launches
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the SSD kernel needs CUDA tensors, got {dev}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    B, S, H, P = x.shape
    if b.dim() != 3 or b.shape[:2] != (B, S) or c.shape != b.shape:
        raise ValueError(f"b and c must be (B, S, N) = ({B}, {S}, N), got "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    N = b.shape[2]
    for name, t in (("dt", dt), ("log_a", log_a)):
        if tuple(t.shape) != (B, S, H):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(B, S, H)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("dt", dt), ("log_a", log_a), ("b", b), ("c", c)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    for name, t in (("b", b), ("c", c)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
    for name, t in (("x", x), ("dt", dt), ("log_a", log_a), ("b", b), ("c", c)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride along its last axis, "
                             f"got {t.stride()}")
    if not 0 < P <= MAX_HEAD_DIM or N <= 0:
        raise ValueError(f"P {P} must be in 1..{MAX_HEAD_DIM} and N {N} positive")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=dev)
    if B * S * H == 0:
        return y
    Q = min(chunk, S)
    lib = _lib()
    smem = lib.ssd_smem_bytes(P, N, Q)
    if smem > SMEM_LIMIT:
        raise ValueError(f"(P, N, chunk) = ({P}, {N}, {Q}) needs {smem} bytes of "
                         f"shared memory, more than a block's {SMEM_LIMIT}")
    if max(B * H, S) >= 2**31:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's int sizes")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_launch(
            x.data_ptr(), dt.data_ptr(), log_a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], B, S, H, P, N, Q,
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            log_a.stride(0), log_a.stride(1), log_a.stride(2),
            b.stride(0), b.stride(1), c.stride(0), c.stride(1), stream)
    if err != 0:
        raise RuntimeError(f"SSD kernel launch failed: cudaError {err}")
    launches += 1
    return y
