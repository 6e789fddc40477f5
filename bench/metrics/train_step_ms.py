"""Mean wall time of a train step in the window (any replica, replays
included), from the batch's arrival to its loss on the host."""


def read(rec):
    steps = rec.window_steps(("train",))
    return 1e3 * sum(s.t1 - s.t0 for s in steps) / len(steps) if steps else None
