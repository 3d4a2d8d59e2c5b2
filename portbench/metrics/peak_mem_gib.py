"""peak_mem_gib.<kind>: ``torch.cuda.max_memory_allocated`` over the run's
program part (set-up, window and traced iterations), in GiB."""


def read(name, rec):
    return rec["peak_bytes"] / 2.0 ** 30 if rec["peak_bytes"] else None
