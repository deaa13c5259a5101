"""What the bf16 tensor-core kernels' TMA copies need of their inputs, for
the wrappers of ``csrc/flash_attention_sm90.cu`` and ``csrc/ssd_sm90.cu``
(both build their tensor maps with ``csrc/sm90.cuh``'s ``make_map``)."""

from __future__ import annotations

import torch

#: what a tensor-core kernel's C function returns beyond cudaError_t
ERRORS = {10000: "a base address or stride is not 16-byte aligned (TMA)",
          10001: "the CUDA runtime found no cuTensorMapEncodeTiled"}


def strides(t: torch.Tensor) -> list[int]:
    """Element strides of every axis but the last (unit-stride) one; a
    dimension of size 1 is never stepped, so its stride is given as 8 (16
    bytes in bf16), which TMA accepts."""
    return [t.stride(i) if t.shape[i] > 1 else 8 for i in range(t.dim() - 1)]


def check(name: str, t: torch.Tensor) -> None:
    """Raises unless ``t`` has a 16-byte aligned base and :func:`strides`
    of a multiple of 16 bytes."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}'s base address is not 16-byte aligned, which "
                         f"the bf16 (TMA) route needs")
    if any((s * t.element_size()) % 16 for s in strides(t)):
        raise ValueError(f"{name} has strides {t.stride()}: the bf16 (TMA) route "
                         f"needs strides of a multiple of 16 bytes")


def launch_error(err: int) -> str:
    """The reason a tensor-core kernel's C function gave for code ``err``."""
    return ERRORS.get(err) or (
        f"cuTensorMapEncodeTiled refused a map: CUresult {err - 10002}"
        if err > 10002 else f"cudaError {err}")
