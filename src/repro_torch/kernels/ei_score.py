"""Multi-tenant EIrate scoring: the wrappers of the three CUDA kernels.

``eirate`` is the counterpart of ``repro.kernels.ei_score.eirate_pallas``:
the kernel (``csrc/ei_score.cu``) scores a tile of 32 model columns per
block, the tenant walk spread over the block (``ei_column.cuh``'s
``tile_totals``); its plain version is ``ref.eirate_ref``.  ``eirate_topk``
is the counterpart of ``eirate_topk_pallas``: the kernel
(``csrc/ei_topk.cu``) scores each block of columns with the same per-column
sum, keeps the block's top-k and merges the blocks' candidates to the
global top-k in one launch; its plain version is ``ref.eirate_topk_ref``.
``eirate_classes`` is the counterpart of
``eirate_classes_pallas``: the kernel (``csrc/ei_classes.cu``) sums the
tenant EI of each column once, with the EIrate kernel's tile body, and
divides it by every device class's cost row; its plain version is
``ref.eirate_classes_ref``.  ``ops`` sends CPU
tensors to the plain versions and CUDA tensors here, where they launch a
kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import ref

#: launches of the EIrate kernel since the last reset (never the CPU path)
launches = 0
#: launches of the EIrate top-k kernel since the last reset
topk_launches = 0
#: launches of the class-axis EIrate kernel since the last reset
classes_launches = 0

_FLOATS = ("mu", "sigma", "best", "cost")
_BYTES = (torch.bool, torch.uint8)


@functools.cache
def _launcher():
    from .. import _build
    fn = _build.load("ei_score").eirate_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _topk_launcher():
    from .. import _build
    fn = _build.load("ei_topk").eirate_topk_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


#: (device index, stream) -> the top-k kernel's ticket counter: one zeroed
#: int32 per stream, which the last block of every launch sets back to 0.
#: Launches on one stream run one after another, so each finds it at 0.
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _ticket(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return t


@functools.cache
def _classes_launcher():
    from .. import _build
    fn = _build.load("ei_classes").eirate_classes_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(kernel, mu, sigma, best, membership, cost, selected):
    """Device, shape, type and contiguity checks shared by the kernels;
    ``cost`` is (n,), or (C, n) for the class-axis kernel.  Returns (N, n)."""
    args = dict(mu=mu, sigma=sigma, best=best, membership=membership,
                cost=cost, selected=selected)
    dev = mu.device
    if dev.type != "cuda":
        raise ValueError(f"the {kernel} kernel needs CUDA tensors, got {dev}")
    n, N = mu.shape[0], best.shape[0]
    cost_shape = (cost.shape[0], n) if kernel == "eirate_classes" else (n,)
    shapes = dict(mu=(n,), sigma=(n,), best=(N,), membership=(N, n),
                  cost=cost_shape, selected=(n,))
    for name, t in args.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, mu on {dev}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if name in _FLOATS and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if name not in _FLOATS and t.dtype not in _BYTES:
            raise TypeError(f"{name} must be bool or uint8, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(N, n) >= 2**31 - ref.BLOCK_MODELS:
        raise ValueError(f"(N, n) = ({N}, {n}) exceeds the kernel's int sizes")
    return N, n


def eirate(mu, sigma, best, membership, cost, selected) -> torch.Tensor:
    """(n,) EIrate scores, -1e30 at selected models, from the kernel.

    mu, sigma, cost: (n,) float32; best: (N,) float32; membership: (N, n)
    and selected: (n,), bool or uint8.  All on one CUDA device, contiguous."""
    global launches
    N, n = _check("eirate", mu, sigma, best, membership, cost, selected)
    dev = mu.device
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(mu.data_ptr(), sigma.data_ptr(), best.data_ptr(),
                 membership.data_ptr(), cost.data_ptr(), selected.data_ptr(),
                 out.data_ptr(), N, n, stream)
    if err != 0:
        raise RuntimeError(f"eirate kernel launch failed: cudaError {err}")
    launches += 1
    return out


def topk_buffers(n: int, k: int, dev: torch.device):
    """What one top-k launch writes: the block candidates' scratch (values,
    indices) and the outputs (values (k,) float32, indices (k,) int32)."""
    bn = min(ref.BLOCK_MODELS, max(n, 1))
    m = -(-n // bn) * min(k, bn)
    scratch = torch.empty(2 * m, dtype=torch.int32, device=dev)
    return (scratch[:m].view(torch.float32), scratch[m:],
            torch.empty(k, dtype=torch.float32, device=dev),
            torch.empty(k, dtype=torch.int32, device=dev))


def topk_launch(mu, sigma, best, membership, cost, selected, k, buffers) -> None:
    """One launch of the top-k kernel into ``buffers`` (:func:`topk_buffers`)
    on the current stream, with no check and no count: the wrapper's launch,
    also timed alone by ``chip_smoke.py``."""
    N, n = membership.shape
    bn = min(ref.BLOCK_MODELS, max(n, 1))
    dev = mu.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _topk_launcher()(
            mu.data_ptr(), sigma.data_ptr(), best.data_ptr(),
            membership.data_ptr(), cost.data_ptr(), selected.data_ptr(),
            *(b.data_ptr() for b in buffers), _ticket(dev, stream).data_ptr(),
            N, n, bn, min(k, bn), k, stream)
    if err != 0:
        raise RuntimeError(f"eirate_topk kernel launch failed: cudaError {err}")


def eirate_topk(mu, sigma, best, membership, cost, selected, *, k: int = 4):
    """(values (k,) float32, global indices (k,) int32) of the EIrate top-k,
    equal values in ascending index, from one launch of the top-k kernel.

    Inputs as :func:`eirate`.  The kernel scores blocks of bn = min(256, n)
    columns, keeps kb = min(k, bn) candidates per block and merges them to
    the global top-k in its last block as ``ref.merge_block_topk`` does
    (mask index >= n, pad to k, stable order); its outputs are returned as
    they are, with no PyTorch op after the launch."""
    global topk_launches
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    N, n = _check("eirate_topk", mu, sigma, best, membership, cost, selected)
    if n == 0:                        # nothing to score: k pads, no launch
        empty = torch.empty(0, dtype=torch.float32, device=mu.device)
        return ref.merge_block_topk(empty, empty.int(), 0, k)
    buffers = topk_buffers(n, k, mu.device)
    topk_launch(mu, sigma, best, membership, cost, selected, k, buffers)
    topk_launches += 1
    return buffers[2], buffers[3]


def eirate_classes(mu, sigma, best, membership, cost_matrix,
                   selected) -> torch.Tensor:
    """(C, n) class-axis EIrate scores from the kernel: row c is the tenant
    EI sum over cost row c; -1e30 at selected models and where the cost is
    not finite (the registry's memory gate).

    Inputs as :func:`eirate`, with ``cost_matrix`` (C, n) float32."""
    global classes_launches
    if cost_matrix.dim() != 2:
        raise ValueError(f"cost_matrix must be (C, n), got shape "
                         f"{tuple(cost_matrix.shape)}")
    N, n = _check("eirate_classes", mu, sigma, best, membership, cost_matrix,
                  selected)
    C = cost_matrix.shape[0]
    if C * n >= 2**31:
        raise ValueError(f"(C, n) = ({C}, {n}) exceeds the kernel's int sizes")
    dev = mu.device
    out = torch.empty((C, n), dtype=torch.float32, device=dev)
    if n == 0 or C == 0:
        return out
    fn = _classes_launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(mu.data_ptr(), sigma.data_ptr(), best.data_ptr(),
                 membership.data_ptr(), cost_matrix.data_ptr(),
                 selected.data_ptr(), out.data_ptr(), N, n, C, stream)
    if err != 0:
        raise RuntimeError(
            f"eirate_classes kernel launch failed: cudaError {err}")
    classes_launches += 1
    return out
