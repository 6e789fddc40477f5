"""The decode-attention kernel's share of its roofline in the traced
stretch, in %: the least time of one launch (harness/flops.py: q in and
out for every lane, each lane's valid cached K/V rows and the slot
positions read once, over 3.35 TB/s) over its mean device time a launch.
The launch's valid rows are the mean over the engine steps whose host
span lies inside the traced stretch."""
from harness import flops

KERNEL = "decode_cluster_kernel"


def read(rec):
    tr = rec.trace
    if not tr:
        return None
    hits = [(n, s) for name, (n, s) in tr["kernels"].items() if KERNEL in name]
    steps = [s for s in rec.steps if s.kind == "decode"
             and s.t0 >= tr["t_on"] and s.t1 <= tr["t_off"]]
    count = sum(n for n, _ in hits)
    if not count or not steps:
        return None
    t = rec.traffic
    valid = sum(s.lanes_valid for s in steps) / len(steps)
    bound = flops.decode_attention_bound_s(rec.run, valid, t["num_slots"],
                                           t["max_seq"])
    return 100.0 * bound / (sum(s for _, s in hits) / count)
