"""splat_roofline.<kind>: the least time of kernels 1 and 2 (the splat's
tile compositing and its backward) from the bytes their valid rows and
pixels need at the HBM peak, over their device time: a share (%)."""

PATTERN = r"\bcomposite_kernel|\bcomposite_bwd_kernel"


def read(name, rec):
    least = rec["work"].get("splat_least_s")
    dev = rec["trace"].kernel_seconds(PATTERN) / max(rec["work"]["iterations"], 1)
    return 100.0 * least / dev if least and dev > 0 else None
