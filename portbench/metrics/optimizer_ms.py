"""optimizer_ms.train: ms per call of ``train/step.py::apply_updates`` (the
densify statistics, the Gaussian Adam and the nets' Adams), between two
synchronisations, over the traced run's timed stretch; one call an
iteration."""


def read(name, rec):
    ms = rec["timers"].get("optimizer")
    return sum(ms) / len(ms) if ms else None
