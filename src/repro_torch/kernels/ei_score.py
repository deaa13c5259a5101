"""Multi-tenant EIrate scoring: the CUDA kernel's wrapper.

Counterpart of ``repro.kernels.ei_score.eirate_pallas``.  The kernel
(``csrc/ei_score.cu``) runs one thread per model column over uint8
membership; its plain version is ``ref.eirate_ref``.  ``ops.eirate``
sends CPU tensors to the plain version and CUDA tensors here, where they
launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

#: kernel launches since the last reset (launches only, never the CPU path)
launches = 0

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


def eirate(mu, sigma, best, membership, cost, selected) -> torch.Tensor:
    """(n,) EIrate scores, -1e30 at selected models, from the kernel.

    mu, sigma, cost: (n,) float32; best: (N,) float32; membership: (N, n)
    and selected: (n,), bool or uint8.  All on one CUDA device, contiguous."""
    global launches
    args = dict(mu=mu, sigma=sigma, best=best, membership=membership,
                cost=cost, selected=selected)
    dev = mu.device
    if dev.type != "cuda":
        raise ValueError(f"the eirate kernel needs CUDA tensors, got {dev}")
    n, N = mu.shape[0], best.shape[0]
    shapes = dict(mu=(n,), sigma=(n,), best=(N,), membership=(N, n),
                  cost=(n,), selected=(n,))
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
    if max(N, n) >= 2**31:
        raise ValueError(f"(N, n) = ({N}, {n}) exceeds the kernel's int sizes")
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
