"""Mean over the window's migrations of the wall time from the start of
the first checkpoint to the switch-over."""


def read(rec):
    d = [m.migration_s for m in rec.done_migrations()]
    return sum(d) / len(d) if d else None
