"""raster_roofline.<kind>: the least time of kernels 3 and 4 (the mesh
tile shader and its backward), the larger of the forward's (pixel, valid
face row) tests at the float32 peak and the bytes their rows and pixels
need at the HBM peak, over their device time: a share (%)."""

PATTERN = r"\bshade_kernel|\bshade_bwd_kernel"


def read(name, rec):
    least = rec["work"].get("raster_least_s")
    dev = rec["trace"].kernel_seconds(PATTERN) / max(rec["work"]["iterations"], 1)
    return 100.0 * least / dev if least and dev > 0 else None
