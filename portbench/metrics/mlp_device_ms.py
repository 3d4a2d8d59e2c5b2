"""mlp_device_ms.<kind>: device ms per profiled iteration (view) of the nets'
kernels: the fused trunk's (``mlp_*``, kernels 5 and 6) and cuBLAS's matrix
products (``gemm``/``gemv`` in the name; the nets make all but a few tiny
ones of them).  The profiled iterations are not anchor or densify
iterations."""

PATTERN = r"mlp_|gemm|gemv"


def read(name, rec):
    n = rec["work"]["iterations"]
    s = rec["trace"].kernel_seconds(PATTERN)
    return 1e3 * s / n if n and s > 0 else None
