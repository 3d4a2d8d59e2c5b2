"""step_mfu.<kind>: the whole iteration's (view's) counted work at the
chip's peak for its arithmetic, over the time per iteration (view) of the
untraced window: a share (%) of the peak.  Counted work: the nets on live
Gaussians and valid vertices, the DPSR's FFTs, the mesh raster's pairs
(portbench/counts/work.py)."""


def read(name, rec):
    least = rec["work"]["step_least_s"]
    return 100.0 * least / (rec["step_ms"] * 1e-3) if least and rec["step_ms"] else None
