"""Causal GQA flash attention (forward): the CUDA kernel's wrapper.

Counterpart of ``repro.kernels.flash_attention.flash_attention_pallas``.
The kernel (``csrc/flash_attention.cu``) streams key and value tiles past
a tile of 64 query rows with a running max and sum in float32, and skips
the tiles that the causal mask or the window leaves empty; its plain
version is ``ref.attention_ref``.  Unlike the TPU kernel it takes any
sequence length (the Pallas ``S % block`` assert is a tiling rule, not part
of the function).  ``ops.flash_attention`` sends CPU tensors to the plain
version and CUDA tensors here, where they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

#: kernel launches since the last reset (launches only, never the CPU path)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


@functools.cache
def _launcher():
    from .. import _build
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _strides(t: torch.Tensor) -> list[int]:
    return [t.stride(0), t.stride(1), t.stride(2)]


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """(B, S, Hq, D) attention output in q's dtype, from the kernel.

    q (B, S, Hq, D), k and v (B, S, Hkv, D), all float32 or all bfloat16 on
    one CUDA device, unit stride along D (other strides are free); Hq a
    multiple of Hkv, D <= 256.  ``window`` (> 0) keeps keys k > q - window."""
    global launches
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the flash attention kernel needs CUDA tensors, got {dev}")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q, k and v must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, S, Hq, D) and k, v (B, S, Hkv, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, D):
        raise ValueError(f"k and v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq {Hq} is not a multiple of Hkv {Hkv}")
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} is outside the kernel's 1..{MAX_HEAD_DIM}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have unit stride along D, got {t.stride()}")
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=dev)
    if B * S * Hq == 0:
        return out
    if B * Hq > 65535:
        raise ValueError(f"B * Hq = {B * Hq} exceeds the kernel's grid (65,535)")
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], B, S, Hq, Hkv, D,
                 *_strides(q), *_strides(k), *_strides(v), *_strides(out),
                 int(causal), window or 0, 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {err}")
    launches += 1
    return out
