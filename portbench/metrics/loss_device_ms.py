"""loss_device_ms.<kind>: device ms per profiled iteration of the kernels,
copies and memsets issued inside the program's ``loss.image`` spans
(train/step.py: the splat image's L1 and D-SSIM, the mesh's mask and image
losses; forward only, their backward runs in ``step.backward``), each device
record linked to its launch as portbench/spans.py does; nothing where the
span never ran or the link does not hold."""

import re

from portbench import spans as S

SPAN = "loss.image"


def _spans(trace):
    """The trace's Spans with the ``loss.*`` spans among the program's
    (portbench/spans.py's pattern predates them)."""
    saved = S.SPAN
    S.SPAN = re.compile(rf"(?:{saved.pattern})|^loss\.[a-z_.]+$")
    try:
        return S.Spans(trace)
    finally:
        S.SPAN = saved


def read(name, rec):
    n = S.iterations(rec)
    if not n:
        return None
    sp = _spans(rec["trace"])
    if not sp.count(SPAN):
        return None
    s = sp.device_seconds(SPAN)
    return 1e3 * s / n if s is not None else None
