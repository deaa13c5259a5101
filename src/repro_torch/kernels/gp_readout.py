"""Incremental-GP posterior readout: the CUDA kernel's wrapper.

Counterpart of ``repro.kernels.gp_readout.gp_readout_pallas``.  The kernel
(``csrc/gp_readout.cu``) reads the k active rows of W once and writes mu
and var (or sd with ``emit_sd``); its plain version is
``ref.gp_readout_ref``.  ``ops.gp_readout`` sends CPU tensors to the plain
version and CUDA tensors here, where they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

#: kernel launches since the last reset (launches only, never the CPU path)
launches = 0


@functools.cache
def _launcher():
    from .. import _build
    fn = _build.load("gp_readout").gp_readout_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gp_readout(W, alpha, mu0, k_diag, *, emit_sd: bool = False):
    """(mu (n,), var (n,)) -- or (mu, sd) with ``emit_sd`` -- from the
    kernel, over W (k, n), alpha (k,), mu0 (n,), k_diag (n,), all float32
    on one CUDA device.  W's rows may be strided (a column slice of a wider
    buffer, unit stride along a row); the others are contiguous.  k may be
    0."""
    global launches
    dev = W.device
    if dev.type != "cuda":
        raise ValueError(f"the gp_readout kernel needs CUDA tensors, got {dev}")
    if W.dim() != 2:
        raise ValueError(f"W must be (k, n), got shape {tuple(W.shape)}")
    k, n = W.shape
    shapes = dict(W=(k, n), alpha=(k,), mu0=(n,), k_diag=(n,))
    args = dict(W=W, alpha=alpha, mu0=mu0, k_diag=k_diag)
    for name, t in args.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, W on {dev}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if name == "W":
            if (k > 0 and n > 1 and W.stride(1) != 1) or (
                    k > 1 and W.stride(0) < n):
                raise ValueError("W must have unit stride along its rows, "
                                 f"got strides {W.stride()}")
        elif not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ldw = W.stride(0) if k > 1 else n
    if max(k, n, ldw) >= 2**31:
        raise ValueError(f"(k, n) = ({k}, {n}) exceeds the kernel's int sizes")
    mu = torch.empty(n, dtype=torch.float32, device=dev)
    var = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return mu, var
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(W.data_ptr(), alpha.data_ptr(), mu0.data_ptr(),
                 k_diag.data_ptr(), mu.data_ptr(), var.data_ptr(), k, n,
                 ldw, int(emit_sd), stream)
    if err != 0:
        raise RuntimeError(f"gp_readout kernel launch failed: cudaError {err}")
    launches += 1
    return mu, var
