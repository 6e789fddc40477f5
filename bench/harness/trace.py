"""A profiled stretch of the window and its reduction.

With ``--trace 1`` the window is profiled from ``at_s`` for ``seconds``
(``torch.profiler``, host and device activities).  The profiler reads
its events when it stops, which takes many seconds, so a mix profiles the
end of the window and the profile stops after the window has closed.  The harness marks what
the host is doing with ``bench.*`` ranges (``span``); the reduction reads
from the profile the device's busy time (the union of its operations'
intervals), the device time of each kernel by name, the operations that
took the most device time, and the device's idle time split by the host
range that was open in the middle of each idle gap.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

MARGIN_S = 0.02   # kept clear of the profile's edges (events near them drop)
WINDOW = "bench.trace_window"


def span(name: str):
    """A host range the profile keeps (a no-op cost when not profiling)."""
    return torch.profiler.record_function(f"bench.{name}")


class Tracer:
    def __init__(self, enabled: bool, at_s: float, seconds: float,
                 clock=None):
        self.enabled, self.clock = enabled, clock
        self.t_on = self.t_off = None
        self.at_s, self.seconds = at_s, seconds
        self.prof = None
        self._range = None
        self.state = "idle" if enabled else "disabled"
        self.summary: Optional[dict] = None

    def arm(self) -> None:
        """From now on ``poll`` starts the profile at ``at_s``."""
        if self.state == "idle":
            self.state = "off"

    def poll(self, t: float) -> None:
        if self.state == "off" and t >= self.at_s:
            self._start()
        elif self.state == "on" and t >= self.at_s + self.seconds:
            self._stop()

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        time.sleep(MARGIN_S)
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()
        self.t_on = self.clock.now
        self.state = "on"

    def _stop(self) -> None:
        torch.cuda.synchronize()
        self.t_off = self.clock.now
        self._range.__exit__(None, None, None)
        time.sleep(MARGIN_S)
        self.prof.stop()
        self.state = "done"

    def finish(self) -> Optional[dict]:
        """Stop a profile still open and reduce it."""
        if self.state == "on":
            self._stop()
        if self.state != "done":
            return None
        self.summary = reduce_events(list(self.prof.events()))
        self.summary.update(t_on=self.t_on, t_off=self.t_off)
        self.prof = None
        return self.summary


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _on_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _is_device(e) -> bool:
    """A device operation: not a host event, and not one of the harness's
    host ranges, which the profiler mirrors onto the device's timeline."""
    return _on_device(e) and not e.name.startswith("bench.")


def reduce_events(events) -> dict:
    """-> window_s, busy_s, kernels {name: [count, device seconds]},
    device_ops (top 10 by device time), idle_gaps (device idle seconds by
    the host range open at each gap's middle, top 10)."""
    win = [e for e in events if e.name == WINDOW and not _on_device(e)]
    if not win:
        raise RuntimeError("the profile holds no trace window range")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev, kernels = [], {}
    for e in events:
        if not _is_device(e):
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a:
            continue
        dev.append((a, b))
        k = kernels.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) * 1e-6
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    host = [(e.time_range.start, e.time_range.end, e.name, e.thread)
            for e in events if e.name.startswith("bench.") and e.name != WINDOW
            and not _on_device(e)]
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        open_ = sorted((e - s, n) for s, e, n, _ in host if s <= mid <= e)
        label = " | ".join(sorted({n for _, n in open_})) or "bench.none"
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "kernels": kernels,
            "device_ops": [[n[:120], s] for n, (_, s) in ops],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                key=lambda kv: -kv[1])[:10]}
