"""iter_ms.<kind>: the untraced window's wall time over the iterations it
completed (the end-to-end ``train_iter_ms`` of a cell whose host-paced runs
spread too widely for it to be held to a bound there)."""


def read(name, rec):
    return rec.get("step_ms")
