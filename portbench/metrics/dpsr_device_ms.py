"""dpsr_device_ms.<kind>: device ms per profiled iteration (view) of cuFFT's
kernels (``fft`` in the name): the DPSR's Poisson solve, forward and
backward, the only FFT user on these paths; nothing where none ran."""


def read(name, rec):
    n = rec["work"]["iterations"]
    s = rec["trace"].kernel_seconds(r"fft")
    return 1e3 * s / n if n and s > 0 else None
