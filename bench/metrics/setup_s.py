"""Everything before the window: the process's start, imports, the kernel
build where the checkout has none yet, the weights drawn on the card, the
warm-up and, for training, the first steps the reference follows."""


def read(rec):
    return rec.setup_s
