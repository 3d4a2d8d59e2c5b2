"""device_idle.<kind>: the share (%) of the profiled sub-window in which no
kernel, copy or memset ran on the device (the union of the profiler's
device intervals)."""


def read(name, rec):
    tr = rec["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr.window_s > 0 else None
