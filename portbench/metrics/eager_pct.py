"""The share of the traced cycle's device time in kernels that are neither
GEMMs nor the port's own (``trace.KINDS``): the eager elementwise,
reduction, copy and other work."""


def read(run):
    t = run.trace
    if t is None or t.kernel_s <= 0:
        return None
    own = t.by_kind.get("gemm", 0.0) + t.by_kind.get("K1-K4", 0.0)
    return 100.0 * (t.kernel_s - own) / t.kernel_s
