"""PyTorch and CUDA port of the multi-device, multi-tenant GP-EI scheduler.

A counterpart of the JAX package ``repro`` that imports neither it nor JAX.
Its entry points take ``device=None``, which means the card; the CPU runs
only when asked for (``device="cpu"``), and then each kernel's plain
PyTorch version stands in for the kernel.  The CUDA kernels are built by
``nvcc`` at first use (``repro_torch._build``).
"""
