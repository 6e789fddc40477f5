"""95th percentile of the gap between consecutive served tokens of one
request, over every generated token of the window (gaps across a
migration's stall included)."""
from store import percentile


def read(rec):
    gaps = [(b[0] - a[0]) * 1e3 for toks in rec.served.values()
            for a, b in zip(toks, toks[1:]) if 0.0 <= a[0] and b[0] <= rec.window_s]
    return percentile(gaps, 95.0) if gaps else None
