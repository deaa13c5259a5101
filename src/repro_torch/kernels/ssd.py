"""Mamba2 SSD chunk scan: the wrapper of its two CUDA routes.

Counterpart of ``repro.kernels.ssd.ssd_pallas``.  The route is chosen by
the dtype of x, b and c alone:

- bfloat16 takes ``"tensor_cores"`` (``csrc/ssd_sm90.cu``): the chunked
  SSD with its four products on wgmma (float32 accumulators), TMA copying
  64-step tiles of x, B and C.  The float32 factors that carry dt and the
  decays (B', W' and the carried state) are split into bf16 hi + lo and
  each product runs on both, so the result keeps float32 accuracy.  Three
  CUDA kernels a call (two when the sequence is one chunk): the chunk
  states, the pass over the chunks, the outputs.  Its plain version step
  for step is ``ref.ssd_chunked_ref``.  TMA needs 16-byte aligned bases
  and strides; other inputs raise.  P <= 128 and N <= 128.
- float32 takes ``"cuda_cores"`` (``csrc/ssd.cu``): one block per
  (batch * head) walks the chunks in order with the (P x N) state in
  shared memory, float32 multiply-adds on the CUDA cores.  P <= 128.

Both take any sequence length (the last chunk may be short) and any chunk
length.  The oracle of both is ``ref.ssd_ref``, the per-step recurrence.
``ops.ssd_mix`` sends CPU tensors to it and CUDA tensors here, where they
launch a route's kernels or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import tma

#: calls that launched a route since the last reset (one a call, whatever
#: the number of CUDA kernels the route runs; never the CPU path)
launches = 0
#: the same calls by route: "tensor_cores" (bf16), "cuda_cores" (float32)
launches_by_route = {"tensor_cores": 0, "cuda_cores": 0}

#: dtype of x, b and c -> route
ROUTES = {torch.bfloat16: "tensor_cores", torch.float32: "cuda_cores"}
#: CUDA kernels one call of the tensor-core route runs: the chunk states,
#: the pass over the chunks (only when there are two or more), the outputs
TENSOR_CORE_KERNELS = ("ssd_chunk_state_kernel", "ssd_state_pass_kernel",
                       "ssd_chunk_out_kernel")
MAX_HEAD_DIM = 128
MAX_STATE_TC = 128            # N of the tensor-core route
SMEM_LIMIT = 232_448          # bytes of shared memory a block may use (H100)


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


def kernels_per_call(S: int, chunk: int) -> int:
    """CUDA kernels one tensor-core call of sequence length S runs."""
    return 3 if S > min(chunk, S) else 2


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
    last axis.  P <= 128; bfloat16 also needs N <= 128 and 16-byte aligned
    bases and strides of x, b and c."""
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
    name = route(x.dtype)
    for tn, t in (("dt", dt), ("log_a", log_a), ("b", b), ("c", c)):
        if t.device != dev:
            raise ValueError(f"{tn} is on {t.device}, x on {dev}")
    for tn, t in (("b", b), ("c", c)):
        if t.dtype != x.dtype:
            raise TypeError(f"{tn} is {t.dtype}, x is {x.dtype}")
    for tn, t in (("x", x), ("dt", dt), ("log_a", log_a), ("b", b), ("c", c)):
        if t.stride(-1) != 1:
            raise ValueError(f"{tn} must have unit stride along its last axis, "
                             f"got {t.stride()}")
    if not 0 < P <= MAX_HEAD_DIM or N <= 0:
        raise ValueError(f"P {P} must be in 1..{MAX_HEAD_DIM} and N {N} positive")
    if name == "tensor_cores" and N > MAX_STATE_TC:
        raise ValueError(f"N {N} exceeds the bf16 (tensor-core) route's "
                         f"{MAX_STATE_TC}")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=dev)
    if B * S * H == 0:
        return y
    Q = min(chunk, S)
    if max(B * H, S) >= 2**31 or (name == "tensor_cores" and max(B, H) > 65535):
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's int sizes")
    if name == "tensor_cores":
        for tn, t in (("x", x), ("b", b), ("c", c)):
            tma.check(tn, t)
        err = _tensor_core_launch(x, dt, log_a, b, c, y, Q)
        if err != 0:
            raise RuntimeError(f"SSD kernel (tensor_cores) launch failed: "
                               f"{tma.launch_error(err)}")
    else:
        lib = _lib()
        smem = lib.ssd_smem_bytes(P, N, Q)
        if smem > SMEM_LIMIT:
            raise ValueError(f"(P, N, chunk) = ({P}, {N}, {Q}) needs {smem} bytes of "
                             f"shared memory, more than a block's {SMEM_LIMIT}")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.ssd_launch(
                x.data_ptr(), dt.data_ptr(), log_a.data_ptr(), b.data_ptr(),
                c.data_ptr(), y.data_ptr(), 0, B, S, H, P, N, Q,
                x.stride(0), x.stride(1), x.stride(2),
                dt.stride(0), dt.stride(1), dt.stride(2),
                log_a.stride(0), log_a.stride(1), log_a.stride(2),
                b.stride(0), b.stride(1), c.stride(0), c.stride(1), stream)
        if err != 0:
            raise RuntimeError(f"SSD kernel (cuda_cores) launch failed: cudaError {err}")
    launches += 1
    launches_by_route[name] += 1
    return y


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
