"""Log entries the target replays per second of replay, over the window's
migrations (an entry: an admission, a decode round or a batch id)."""


def read(rec):
    ms = [m for m in rec.done_migrations() if m.replay_s > 0]
    if not ms:
        return None
    return sum(m.replay_entries for m in ms) / sum(m.replay_s for m in ms)
