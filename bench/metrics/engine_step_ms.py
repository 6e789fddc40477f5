"""Mean wall time of an engine step (a forced prompt step or a decode
round, any replica) in the window."""


def read(rec):
    steps = rec.window_steps(("fold", "decode"))
    return 1e3 * sum(s.t1 - s.t0 for s in steps) / len(steps) if steps else None
