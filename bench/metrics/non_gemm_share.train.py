"""Share of the profiled device time spent in operations that are not
matrix products, in %.  A product is an operation whose name holds one of
``GEMM_NAMES`` (cuBLAS, cuBLASLt and CUTLASS kernels); the hand-written
SSD and aggregation kernels count as not products."""

GEMM_NAMES = ("gemm", "gemv", "xmma", "cutlass", "nvjet", "cublas")


def read(run):
    prof = run.get("profile")
    if prof is None or not prof.ops:
        return None
    total = prof.total_s()
    gemm = sum(e - s for n, s, e in prof.ops if any(g in n.lower() for g in GEMM_NAMES))
    return 100.0 * (total - gemm) / total
