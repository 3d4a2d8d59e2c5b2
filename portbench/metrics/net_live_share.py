"""net_live_share.<kind>: the share (%) of the rows the nets ran that are live
Gaussians or valid mesh vertices, over the profiled stretch: 100 x the sum of
the program's ``nets.live_rows.*`` counters over the sum of its
``nets.rows.*`` (dgmesh_torch/tracing.py; they move only while a profiler
records, and a run profiles one stretch); nothing where the program has no
such counters."""


def read(name, rec):
    try:
        from dgmesh_torch import tracing
    except ImportError:
        return None
    c = tracing.counts()
    rows = sum(v for k, v in c.items() if k.startswith("nets.rows."))
    live = sum(v for k, v in c.items() if k.startswith("nets.live_rows."))
    return 100.0 * live / rows if rows else None
