"""Deterministic latency statistics shared by the serving harness, the
operator CLI and the benchmark report rows.

Tail latency is the headline metric of the serving-handoff subsystem
(SHADOW's point: for serving workloads *perceived* latency matters, not
control-plane downtime), so the percentile math must be bit-reproducible
across runs and platforms: plain sorted-order linear interpolation over
float64, no numpy version-dependent quantile methods.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

# the serving benchmarks' standard tail grid
LATENCY_PERCENTILES = (50.0, 99.0, 99.9)


def percentile(values: Sequence[float], p: float) -> float:
    """Linear-interpolated percentile (the classic ``(n-1)``-rank method).

    ``p`` is in [0, 100].  Deterministic: sorted copy, rank
    ``p/100 * (n-1)``, linear interpolation between the two neighbouring
    order statistics — exactly numpy's default, but pinned here so a
    numpy method change can never silently move the reported tails.
    """
    if not 0.0 <= p <= 100.0:
        raise ValueError(f"percentile out of range: {p}")
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of an empty sequence")
    if len(xs) == 1:
        return xs[0]
    rank = (p / 100.0) * (len(xs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


def percentiles(values: Sequence[float],
                ps: Sequence[float] = LATENCY_PERCENTILES
                ) -> Dict[str, float]:
    """``{"p50": ..., "p99": ..., "p999": ...}`` — key = ``p`` + the
    percentile with the decimal point dropped (99.9 -> ``p999``)."""
    out: Dict[str, float] = {}
    for p in ps:
        key = "p" + f"{p:g}".replace(".", "")
        out[key] = percentile(values, p)
    return out


def latency_summary(latencies: Sequence[float],
                    ps: Sequence[float] = LATENCY_PERCENTILES,
                    ndigits: Optional[int] = 4) -> Dict[str, float]:
    """The serving benchmarks' standard latency row: sample count, mean,
    max and the tail grid, all rounded to ``ndigits`` for stable JSON.
    Empty input yields an all-None row (a run that completed nothing
    must not crash the report)."""
    keys = ["p" + f"{p:g}".replace(".", "") for p in ps]
    if not latencies:
        row: Dict[str, float] = {"n": 0, "mean": None, "max": None}
        row.update({k: None for k in keys})
        return row
    xs = [float(v) for v in latencies]
    row = {"n": len(xs), "mean": sum(xs) / len(xs), "max": max(xs)}
    row.update(percentiles(xs, ps))
    if ndigits is not None:
        row = {k: (round(v, ndigits) if isinstance(v, float) else v)
               for k, v in row.items()}
    return row


def summarize_spans(spans: Sequence[float],
                    ndigits: int = 3) -> Dict[str, float]:
    """p50/p99 digest for benchmark aggregate rows (fleet spans, chaos
    exposure windows): the distribution shape, not just the mean."""
    if not spans:
        return {"p50": None, "p99": None}
    return {"p50": round(percentile(spans, 50.0), ndigits),
            "p99": round(percentile(spans, 99.0), ndigits)}


__all__: List[str] = ["LATENCY_PERCENTILES", "percentile", "percentiles",
                      "latency_summary", "summarize_spans"]
