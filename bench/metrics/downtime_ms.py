"""Mean over the window's migrations of the wall time from the source's
last step to the target's first step after the switch-over."""


def read(rec):
    d = [m.downtime_s for m in rec.done_migrations() if m.downtime_s is not None]
    return 1e3 * sum(d) / len(d) if d else None
