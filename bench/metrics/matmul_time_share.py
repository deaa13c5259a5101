"""Percent of a profiled training step's kernel time spent in matrix-product
kernels, told by name in the device trace (cuBLAS's and CUTLASS's GEMM and
GEMV kernels, cuBLAS's split-K reductions); the rest is the scan's and the
other elementwise kernels'."""

GEMM = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas", "splitkreduce")


def read(ctx):
    prof = ctx["profile"]
    if prof is None or not prof["kernel_s"]:
        return None
    matmul = sum(s for name, s in prof["kernel_s_by_name"].items()
                 if any(g in name.lower() for g in GEMM))
    return 100.0 * matmul / prof["kernel_s"]
