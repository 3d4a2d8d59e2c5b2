"""mt_device_ms.<kind>: device ms per profiled iteration (view) of the kernels,
copies and memsets issued inside the program's ``mesh.marching_tets`` span
(ops/marching_tets.py; its backward runs in ``step.backward``), each device
record linked to its launch as portbench/spans.py does; nothing where the
span never ran or the link does not hold."""

from portbench import spans as S


def read(name, rec):
    n = S.iterations(rec)
    sp = S.of(rec["trace"])
    if not n or not sp.count("mesh.marching_tets"):
        return None
    s = sp.device_seconds("mesh.marching_tets")
    return 1e3 * s / n if s is not None else None
