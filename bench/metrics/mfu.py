"""The whole window's model FLOPs over the card's bf16 peak, in %: per
served token 2 flops a weight it multiplies
with plus its attention's products at its position; per trained batch 6
flops a weight a token plus three times the causal attention's forward
products.  Counted from the configuration's sizes (harness/flops.py),
not from the program."""
from harness import flops


def read(rec):
    return flops.window_mfu(rec)
