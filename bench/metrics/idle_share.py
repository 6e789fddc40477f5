"""The device's idle share of the traced stretch of the window, in %:
1 less the union of its operations' intervals over the stretch."""
from harness import flops


def read(rec):
    return flops.idle_share(rec)
