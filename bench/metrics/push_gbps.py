"""Image bytes pushed over the pushes' wall time (the registry's
fingerprints, host copies, sha256 and the store), over the window's
migrations."""


def read(rec):
    ms = [m for m in rec.migrations if m.t_push1 > m.t_push0 and m.push_bytes]
    if not ms:
        return None
    return sum(m.push_bytes for m in ms) / sum(m.t_push1 - m.t_push0
                                               for m in ms) / 1e9
