"""trunk_roofline.train: the least time of the fused trunk's kernels 5 and
6 (``mlp_fwd_kernel``, ``mlp_bwd_*``) from the products the live rows and
valid vertices need at the bf16 tensor-core peak, over their device time: a
share (%).  The kernels run on every padded slot, so the dead slots' work
shows as lost share."""

PATTERN = r"\bmlp_fwd_kernel|\bmlp_bwd_"


def read(name, rec):
    least = rec["work"].get("trunk_least_s")
    dev = rec["trace"].kernel_seconds(PATTERN) / max(rec["work"]["iterations"], 1)
    return 100.0 * least / dev if least and dev > 0 else None
