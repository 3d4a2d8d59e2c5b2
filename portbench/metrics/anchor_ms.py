"""anchor_ms.train: ms per call of ``train/loop.py::anchor_fn`` (the float32
deform, the mesh with frozen positions, the kNN anchoring), between two
synchronisations; nothing where the timed stretch held no anchor."""


def read(name, rec):
    ms = rec["timers"].get("anchor")
    return sum(ms) / len(ms) if ms else None
