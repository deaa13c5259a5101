"""Causal GQA flash attention (forward): the wrapper of its two CUDA kernels.

Counterpart of ``repro.kernels.flash_attention.flash_attention_pallas``.
The route is chosen by the inputs' dtype alone:

- bfloat16 q, k, v take ``"wgmma"`` (``csrc/flash_attention_sm90.cu``):
  TMA streams 128-row key and value tiles past 128 query rows, both
  products run on the tensor cores (wgmma, float32 accumulators), the
  online softmax runs on the accumulators in registers, and the float32
  probabilities enter P V as bf16 hi + lo (two wgmmas a k16 slice), so P
  keeps about 16 significant bits.  Its arithmetic step for step is
  ``ref.attention_wgmma_route_ref``.  TMA needs 16-byte aligned base
  addresses and strides; other inputs raise.
- float32 q, k, v take ``"tf32x3"`` (``csrc/flash_attention.cu``): both
  products on the tensor cores (tf32 wgmma, float32 accumulators), each
  float32 factor split into tf32 hi + lo (rounded to nearest) and each
  product taken as hi hi + hi lo + lo hi, which keeps float32 accuracy
  where one TF32 product would not.  Loads go through the threads that
  split them (cp.async, 16 or 4 bytes), so any base and strides with unit
  stride along D are taken.  Its arithmetic tile for tile is
  ``ref.attention_tf32x3_route_ref``.

Both skip the tiles that the causal mask or the window leaves empty, and
take any sequence length (the Pallas ``S % block`` assert is a tiling rule,
not part of the function).  Their plain version is ``ref.attention_ref``.
``ops.flash_attention`` sends CPU tensors to it and CUDA tensors here,
where they launch a kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import tma

#: kernel launches since the last reset (launches only, never the CPU path)
launches = 0
#: the same launches by route: "wgmma" (bf16), "tf32x3" (float32)
launches_by_route = {"wgmma": 0, "tf32x3": 0}

#: dtype -> (route, source under csrc/, C entry point)
ROUTES = {torch.bfloat16: ("wgmma", "flash_attention_sm90",
                           "flash_attention_sm90_launch"),
          torch.float32: ("tf32x3", "flash_attention",
                          "flash_attention_launch")}
MAX_HEAD_DIM = 256


def reset_launches() -> None:
    global launches
    launches = 0
    for route in launches_by_route:
        launches_by_route[route] = 0


@functools.cache
def _launcher(dtype: torch.dtype):
    from .. import _build
    _, source, entry = ROUTES[dtype]
    fn = getattr(_build.load(source), entry)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def route(dtype: torch.dtype) -> str:
    """The kernel that inputs of ``dtype`` take."""
    if dtype not in ROUTES:
        raise TypeError(f"q, k and v must be float32 or bfloat16, got {dtype}")
    return ROUTES[dtype][0]


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """(B, S, Hq, D) attention output in q's dtype, from the kernel of the
    dtype's route.

    q (B, S, Hq, D), k and v (B, S, Hkv, D), all float32 or all bfloat16 on
    one CUDA device, unit stride along D; Hq a multiple of Hkv, D <= 256;
    bfloat16 also needs 16-byte aligned bases and (b, s, h) strides.
    ``window`` (> 0) keeps keys k > q - window."""
    global launches
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the flash attention kernel needs CUDA tensors, got {dev}")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    name = route(q.dtype)
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
    for tn, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{tn} must have unit stride along D, got {t.stride()}")
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=dev)
    if B * S * Hq == 0:
        return out
    if B * Hq > 65535:
        raise ValueError(f"B * Hq = {B * Hq} exceeds the kernel's grid (65,535)")
    if name == "wgmma":
        for tn, t in (("q", q), ("k", k), ("v", v)):
            tma.check(tn, t)
    fn = _launcher(q.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, Hq, Hkv, D,
                 *tma.strides(q), *tma.strides(k), *tma.strides(v), *tma.strides(out),
                 int(causal), window or 0, 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel ({name}) launch failed: "
                           f"{tma.launch_error(err)}")
    launches += 1
    launches_by_route[name] += 1
    return out
