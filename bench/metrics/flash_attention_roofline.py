"""The flash forward kernel's share of its roofline in the train step's
launches of the traced stretch, in %: the least time of one causal
launch at the batch's shape (harness/flops.py: q, k, v in and the output
out over 3.35 TB/s, against 4·D operations per kept pair over 989
TFLOP/s) over its mean device time a launch."""
from harness import flops

KERNEL = "flash_wgmma_kernel"


def read(rec):
    tr = rec.trace
    if not tr:
        return None
    hits = [(n, s) for name, (n, s) in tr["kernels"].items() if KERNEL in name]
    count = sum(n for n, _ in hits)
    if not count:
        return None
    t = rec.traffic
    bound = flops.flash_forward_bound_s(rec.run, t["batch"], t["seq"])
    return 100.0 * bound / (sum(s for _, s in hits) / count)
