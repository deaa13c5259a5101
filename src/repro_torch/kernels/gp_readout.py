"""Incremental-GP posterior readout: the CUDA kernel's wrapper.

Counterpart of ``repro.kernels.gp_readout.gp_readout_pallas``.  The kernels
(``csrc/gp_readout.cu``) read the k active rows of W once and write mu and
var (or sd with ``emit_sd``), each column folded in ascending row order by
one thread; their plain version is ``ref.gp_readout_ref``.  :func:`path`
picks how the rows arrive: a small problem (the Fig-5 episode's
per-tenant blocks) is copied whole into one block's shared memory in one
wave (``"slab"``); a long walk (k >= :data:`BULK_MIN_ROWS`) over many
columns (n >= :data:`BULK_MIN_COLUMNS`), with W's base and row stride
16-byte aligned, streams through a ring of TMA bulk copies, a block per
256 columns: ``"bulk"`` where those blocks cover the card's SMs (service
size), ``"bulk_deep"``, a deeper ring a block, where they do not (the
sharded scorer's column slices); anything else takes one thread a column
and 4-byte loads (``"column"``: slices at any offset, small k or n).  The
two limits are where ``tools/readout_paths.py`` timed the column kernel
fastest below them (PERF.md §6).  ``ops.gp_readout`` sends CPU tensors
to the plain version and CUDA tensors here, where they launch the kernel
or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

#: kernel launches since the last reset (launches only, never the CPU path)
launches = 0
#: the slab kernel's limit on k*n + k + 2n (48 KB of shared memory)
SLAB_FLOATS = 12_288
#: columns a block of the bulk kernels
BULK_COLUMNS = 256
#: the bulk kernels' limits: fewer rows or columns take the column kernel
BULK_MIN_ROWS = 256
BULK_MIN_COLUMNS = 4096
#: the C interface's path indices
PATHS = ("slab", "bulk", "bulk_deep", "column")
#: launches by path since the last :func:`reset_launches`
launches_by_path = dict.fromkeys(PATHS, 0)


def reset_launches() -> None:
    """Sets :data:`launches` and :data:`launches_by_path` to 0."""
    global launches
    launches = 0
    for p in launches_by_path:
        launches_by_path[p] = 0


@functools.cache
def _launcher():
    from .. import _build
    fn = _build.load("gp_readout").gp_readout_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def path(k: int, n: int, ldw: int, base: int, *, sms: int) -> str:
    """The kernel that W (k, n) with row stride ``ldw`` at address
    ``base`` takes on a card of ``sms`` SMs (one of :data:`PATHS`)."""
    if k * n + k + 2 * n <= SLAB_FLOATS:
        return "slab"
    if (k >= BULK_MIN_ROWS and n >= BULK_MIN_COLUMNS and n % 4 == 0
            and ldw % 4 == 0 and base % 16 == 0):
        return "bulk" if -(-n // BULK_COLUMNS) >= sms else "bulk_deep"
    return "column"


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
    sms = _sms(dev.index if dev.index is not None else torch.cuda.current_device())
    taken = path(k, n, ldw, W.data_ptr(), sms=sms)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(W.data_ptr(), alpha.data_ptr(), mu0.data_ptr(),
                 k_diag.data_ptr(), mu.data_ptr(), var.data_ptr(), k, n,
                 ldw, int(emit_sd), PATHS.index(taken), stream)
    if err != 0:
        raise RuntimeError(f"gp_readout kernel launch failed: cudaError {err}")
    launches += 1
    launches_by_path[taken] += 1
    return mu, var
