"""Mamba2 SSD chunk scan: the wrapper of its two CUDA routes.

Counterpart of ``repro.kernels.ssd.ssd_pallas``.  The route is chosen by
the dtype of x, b and c alone; both run the chunked SSD on the tensor
cores (:data:`ROUTE_KERNELS`: the chunk states, the pass over the chunks,
the outputs, and on the float32 route the chunk products between them).

- bfloat16 takes ``"tensor_cores"`` (``csrc/ssd_sm90.cu``): its four
  products on bf16 wgmma (float32 accumulators), TMA copying 64-step tiles
  of x, B and C.  The float32 factors that carry dt and the decays (B', W'
  and the carried state) are split into bf16 hi + lo and each product runs
  on both, so the result keeps float32 accuracy.  Three CUDA kernels a
  call, two for a sequence of one chunk (the states kernel still takes
  lcum).  Its plain version step for step is ``ref.ssd_chunked_ref``.
  TMA needs 16-byte aligned bases and strides; other inputs raise.
- float32 takes ``"tf32x3"`` (``csrc/ssd.cu``): the same products on tf32
  wgmma, every float32 factor split into tf32 hi + lo and each product
  taken as three TF32 products (hi lo + lo hi + hi hi), raw tiles copied
  by cp.async (16 or 4 bytes, so any view) and split by the threads.  Four
  CUDA kernels a call, two for a sequence of one chunk (the chunk products,
  G = C B^T into a scratch of ``ceil(S / chunk)`` triangles of
  ``ceil(chunk / 64)``^2 / 2 tiles of 16 KB, and the outputs).  Its plain
  version step for step is ``ref.ssd_tf32x3_route_ref``.

Both take any sequence length (the last chunk may be short), any chunk
length, P <= 128 and N <= 128.  The oracle of both is ``ref.ssd_ref``,
the per-step recurrence.  ``ops.ssd_mix`` sends CPU tensors to it and CUDA
tensors here, where they launch a route's kernels or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import tma

#: calls that launched a route since the last reset (one a call, whatever
#: the number of CUDA kernels the route runs; never the CPU path)
launches = 0
#: the same calls by route: "tensor_cores" (bf16), "tf32x3" (float32)
launches_by_route = {"tensor_cores": 0, "tf32x3": 0}

#: dtype of x, b and c -> route
ROUTES = {torch.bfloat16: "tensor_cores", torch.float32: "tf32x3"}
#: route -> its CUDA kernels in launch order: the chunk states, the pass
#: over the chunks, (float32) the chunk products G = C B^T and C in^T, the
#: outputs (which of them a call runs: :func:`call_kernels`)
ROUTE_KERNELS = {
    "tensor_cores": ("ssd_chunk_state_kernel", "ssd_state_pass_kernel",
                     "ssd_chunk_out_kernel"),
    "tf32x3": ("ssd_tf32x3_state_kernel", "ssd_tf32x3_pass_kernel",
               "ssd_tf32x3_chunk_kernel", "ssd_tf32x3_out_kernel"),
}
MAX_HEAD_DIM = 128            # P of both routes
MAX_STATE = 128               # N of both routes


def reset_launches() -> None:
    global launches
    launches = 0
    for r in launches_by_route:
        launches_by_route[r] = 0


def route(dtype: torch.dtype) -> str:
    """The route that x, b and c of ``dtype`` take."""
    if dtype not in ROUTES:
        raise TypeError(f"x must be float32 or bfloat16, got {dtype}")
    return ROUTES[dtype]


def call_kernels(name: str, S: int, chunk: int) -> tuple[str, ...]:
    """The CUDA kernels one call of route ``name`` runs at sequence length
    S: all of them when the sequence spans two or more chunks; for one
    chunk, which carries no state, the bf16 route's states kernel (which
    takes lcum) and outputs, the float32 route's chunk products (G alone)
    and outputs."""
    kernels = ROUTE_KERNELS[name]
    if S > min(chunk, S):
        return kernels
    return (kernels[0], kernels[-1]) if name == "tensor_cores" else kernels[2:]


@functools.cache
def _lib():
    from .. import _build
    fn = _build.load("ssd").ssd_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 13 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm90():
    from .. import _build
    fn = _build.load("ssd_sm90").ssd_sm90_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 13 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ssd_mix(x, dt, log_a, b, c, *, chunk: int = 256):
    """The SSD mix y (B, S, H, P) float32 (without the D * x skip term),
    from the kernels of the inputs' route, in chunks of ``min(chunk, S)``
    steps.

    x (B, S, H, P) and b/c (B, S, N), all float32 or all bfloat16; dt and
    log_a (B, S, H) float32; all on one CUDA device, unit stride along the
    last axis.  P <= 128 and N <= 128; bfloat16 also needs 16-byte aligned
    bases and strides of x, b and c.  The shapes are checked before the
    device, so a refused shape launches nothing on any device."""
    global launches
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
    name = route(x.dtype)
    for tn, t in (("b", b), ("c", c)):
        if t.dtype != x.dtype:
            raise TypeError(f"{tn} is {t.dtype}, x is {x.dtype}")
    for tn, t in (("x", x), ("dt", dt), ("log_a", log_a), ("b", b), ("c", c)):
        if t.stride(-1) != 1:
            raise ValueError(f"{tn} must have unit stride along its last axis, "
                             f"got {t.stride()}")
    if not 0 < P <= MAX_HEAD_DIM:
        raise ValueError(f"P {P} must be in 1..{MAX_HEAD_DIM}")
    if not 0 < N <= MAX_STATE:
        raise ValueError(f"N {N} must be in 1..{MAX_STATE}: the {name} route "
                         f"keeps a chunk's N columns of C and B in shared memory")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the SSD kernel needs CUDA tensors, got {dev}")
    for tn, t in (("dt", dt), ("log_a", log_a), ("b", b), ("c", c)):
        if t.device != dev:
            raise ValueError(f"{tn} is on {t.device}, x on {dev}")
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=dev)
    if B * S * H == 0:
        return y
    Q = min(chunk, S)
    if max(B * H, S) >= 2**31 or max(B, H) > 65535:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernels' int sizes")
    if name == "tensor_cores":
        for tn, t in (("x", x), ("b", b), ("c", c)):
            tma.check(tn, t)
        err = _tensor_core_launch(x, dt, log_a, b, c, y, Q)
        if err != 0:
            raise RuntimeError(f"SSD kernel (tensor_cores) launch failed: "
                               f"{tma.launch_error(err)}")
    else:
        err = _tf32x3_launch(x, dt, log_a, b, c, y, Q)
        if err != 0:
            raise RuntimeError(f"SSD kernel (tf32x3) launch failed: cudaError {err}")
    launches += 1
    launches_by_route[name] += 1
    return y


def _tf32x3_launch(x, dt, log_a, b, c, y, Q: int) -> int:
    """The float32 route's kernels on the current stream, with their
    scratch, all float32: the G tiles (B, nc, T, 4096), T = ts (ts + 1) / 2
    of the ts = ceil(Q / 64) slabs of a chunk; and when the sequence spans
    two or more chunks l_end (B, H, nc - 1), the chunk states (B, H, nc - 1,
    P, N) and the entering states' tf32 hi and lo tiles (B, H, nc - 1, PH,
    2, 64, NP), PH = ceil(P / 64) and NP = N rounded up to 64 or 128."""
    B, S, H, P = x.shape
    N = b.shape[2]
    nc = -(-S // Q)
    ts = -(-Q // 64)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    gram = torch.empty((B, nc, ts * (ts + 1) // 2, 4096), **f32)
    l_end = states = tiles = None
    if nc > 1:
        l_end = torch.empty((B, H, nc - 1), **f32)
        states = torch.empty((B, H, nc - 1, P, N), **f32)
        tiles = torch.empty((B, H, nc - 1, -(-P // 64), 2, 64, 64 if N <= 64 else 128),
                            **f32)
    ptrs = [None if t is None else t.data_ptr() for t in (l_end, states, tiles, gram)]
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        return fn(x.data_ptr(), dt.data_ptr(), log_a.data_ptr(), b.data_ptr(),
                  c.data_ptr(), y.data_ptr(), *ptrs, B, S, H, P, N, Q,
                  x.stride(0), x.stride(1), x.stride(2), b.stride(0), b.stride(1),
                  c.stride(0), c.stride(1), dt.stride(0), dt.stride(1), dt.stride(2),
                  log_a.stride(0), log_a.stride(1), log_a.stride(2), stream)


def _tensor_core_launch(x, dt, log_a, b, c, y, Q: int) -> int:
    """The tensor-core route's three kernels on the current stream, with
    their scratch: lcum (B, H, S) and the chunk states (B, H, nc - 1, P, N),
    both float32, and the entering states' bf16 hi and lo tiles (B, H,
    nc - 1, 2, PP, NP), PP and NP = P and N rounded up to 64 or 128."""
    B, S, H, P = x.shape
    N = b.shape[2]
    nc = -(-S // Q)
    PP, NP = (64 if P <= 64 else 128), (64 if N <= 64 else 128)
    dev = x.device
    lcum = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    states = torch.empty((B, H, max(nc - 1, 1), P, N), dtype=torch.float32, device=dev)
    tiles = torch.empty((B, H, max(nc - 1, 1), 2, PP, NP), dtype=torch.bfloat16,
                        device=dev)
    fn = _sm90()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        return fn(x.data_ptr(), dt.data_ptr(), log_a.data_ptr(), b.data_ptr(),
                  c.data_ptr(), y.data_ptr(), lcum.data_ptr(), states.data_ptr(),
                  tiles.data_ptr(), B, S, H, P, N, Q, *tma.strides(x), *tma.strides(b),
                  *tma.strides(c), dt.stride(0), dt.stride(1), dt.stride(2),
                  log_a.stride(0), log_a.stride(1), log_a.stride(2), stream)
