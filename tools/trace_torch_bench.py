#!/usr/bin/env python
"""One benchmark cell with the port's spans on, and what they read.

  python tools/trace_torch_bench.py --workload <cell> --seed <n>
      [--seconds 51] [--spans 0|1] [--profile 0|1] [--sync-debug]
      [--out FILE]

Builds and runs the cell as ``bench/run.py`` does (``BENCHMARK.json``,
the harness in ``bench/``) on the CUDA card, but turns the port's tracing
(``repro_torch.trace``) on at set-up's end, on the cell's own clock, so
that every span reads in the seconds of the harness's steps and
migrations; it turns it off after the window.  ``--spans 0`` leaves it
off (the same run, for the tracing's cost).  The comparison with the
plain reference is not run.  Prints one JSON line (and writes it to
``--out``):

* ``bench``: the harness's own readings (``engine_step_ms`` or
  ``train_step_ms``, ``push_gbps``, ``downtime_ms``, ``migration_s``,
  ``tokens_per_s``);
* ``spans``: the span readings (``SPAN_READINGS``): the step's host
  dispatch and its wait on the device, a mean over the window's steps,
  and the push's copies off the card and its sha256, the pull and the
  restore in GB/s over the window's migrations;
* ``migrations``: each migration's seconds, bytes and GB/s by program
  phase (``PHASES``), beside the push's wall;
* ``counters``: the window's deltas of ``repro_torch.trace.counters()``;
* with ``--profile 1`` (the harness's traced stretch, the window's last
  seconds): ``trace``, the device's busy and idle time with the port's
  ranges, which the profiler mirrors onto the device's timeline, left
  out of device operations; the idle time by the harness's host range
  with the innermost port span open at each gap's middle appended
  (``bench.engine_step > repro_torch.engine.dispatch``); and, for
  comparison, the idle share the harness's own reduction reads with the
  mirrored ranges counted;
* with ``--sync-debug``: the operations that synchronised with the
  device during the window (``torch.cuda.set_sync_debug_mode("warn")``)
  by the innermost port span open on their thread.

Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import sys
import time
import warnings
from collections import Counter
from typing import Dict, List, Optional

T_START = time.perf_counter()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.join(REPO, "src"), os.path.join(REPO, "bench")):
    if _p not in sys.path:
        sys.path.append(_p)

PORT = "repro_torch."
DISPATCH = ("repro_torch.engine.dispatch", "repro_torch.trainer.dispatch")
SYNC = ("repro_torch.engine.sync", "repro_torch.trainer.sync")
LOAD_STATE = ("repro_torch.engine.load_state",
              "repro_torch.trainer.load_state")
PHASES = ("engine.state_tree", "trainer.state_tree", "registry.push",
          "registry.fingerprint", "registry.d2h", "registry.hash",
          "registry.put", "registry.pull", "registry.get",
          "registry.assemble", "registry.place", "engine.load_state",
          "trainer.load_state")
PUSH_PARTS = ("registry.fingerprint", "registry.d2h", "registry.hash",
              "registry.put")
BENCH_READERS = ("engine_step_ms", "train_step_ms", "push_gbps",
                 "downtime_ms", "migration_s", "tokens_per_s")


# ------------------------------------------------------------ span readings
def step_mean_ms(spans, steps, names) -> Optional[float]:
    """The mean over ``steps`` of the time spans named ``names`` took
    inside each step's host interval, in ms; None without such spans."""
    mine = sorted((s.t0, s.t1) for s in spans if s.name in names)
    if not steps or not mine:
        return None
    starts = [a for a, _ in mine]
    total, hit = 0.0, False
    for st in steps:
        i = bisect.bisect_left(starts, st.t0)
        while i < len(mine) and mine[i][0] <= st.t1:
            a, b = mine[i]
            if b <= st.t1:
                total += b - a
                hit = True
            i += 1
    return 1e3 * total / len(steps) if hit else None


def _migration_spans(spans, rec, names):
    """Spans named ``names`` that ran inside one of the window's
    migrations, from its checkpoint until its target was restored."""
    out = []
    for m in rec.migrations:
        hi = m.t_ready if m.t_ready is not None else float("inf")
        out += [s for s in spans if s.name in names
                and m.t_start <= s.t0 and s.t1 <= hi]
    return out


def gbps(spans) -> Optional[float]:
    """Bytes over the spans' summed wall, GB/s; None without bytes."""
    wall = sum(s.t1 - s.t0 for s in spans)
    nbytes = sum(s.nbytes for s in spans)
    return nbytes / wall / 1e9 if wall > 0 and nbytes else None


def window_steps(rec):
    return rec.window_steps(("fold", "decode", "train"))


SPAN_READINGS = {
    # the step's host dispatch (launches up to the result on the device)
    "dispatch_ms": lambda sp, rec: step_mean_ms(sp, window_steps(rec),
                                                DISPATCH),
    # the step's wait on the host for the device's result
    "sync_wait_ms": lambda sp, rec: step_mean_ms(sp, window_steps(rec),
                                                 SYNC),
    "push_d2h_gbps": lambda sp, rec: gbps(_migration_spans(
        sp, rec, ("repro_torch.registry.d2h",))),
    "push_hash_gbps": lambda sp, rec: gbps(_migration_spans(
        sp, rec, ("repro_torch.registry.hash",))),
    "pull_gbps": lambda sp, rec: gbps(_migration_spans(
        sp, rec, ("repro_torch.registry.pull",))),
    "restore_gbps": lambda sp, rec: gbps(_migration_spans(
        sp, rec, LOAD_STATE)),
}


def span_readings(spans, rec) -> Dict[str, Optional[float]]:
    return {k: f(spans, rec) for k, f in SPAN_READINGS.items()}


def migration_phases(spans, rec) -> List[dict]:
    """Each migration's phases: [seconds, bytes, GB/s] by span name, the
    push's wall, and the push's parts summed."""
    out = []
    for m in rec.migrations:
        hi = m.t_ready if m.t_ready is not None else float("inf")
        mine = [s for s in spans if m.t_start <= s.t0 and s.t1 <= hi]
        row = {"t_start": m.t_start, "t_ready": m.t_ready,
               "push_wall_s": m.t_push1 - m.t_push0}
        for ph in PHASES:
            got = [s for s in mine if s.name == PORT + ph]
            if got:
                sec = sum(s.t1 - s.t0 for s in got)
                nb = sum(s.nbytes for s in got)
                row[ph] = [sec, nb, nb / sec / 1e9 if sec > 0 else None]
        row["push_parts_s"] = sum(row[p][0] for p in PUSH_PARTS if p in row)
        out.append(row)
    return out


def counter_deltas(before: dict, after: dict) -> dict:
    return {kind: {k: v - before[kind].get(k, 0)
                   for k, v in after[kind].items()
                   if v != before[kind].get(k, 0)}
            for kind in after}


# --------------------------------------------------------- trace reduction
def _is_port(name: str) -> bool:
    return name.startswith(PORT)


def reduce_labelled(events) -> dict:
    """The harness's reduction (``bench/harness/trace.py``) with the port's
    ranges left out of device operations, and its idle gaps labelled by
    the harness's host range followed by the innermost port span open on
    the same thread at the gap's middle.  -> ``window_s``, ``busy_s``,
    ``idle_share`` (%), ``device_ops``, ``idle_gaps`` (top 10),
    ``idle_by_span`` (idle seconds by innermost port span),
    ``port_labelled_share`` (% of the idle time with a port span), and
    ``idle_share_mirrored`` (% read with the port's ranges counted as
    device time, as the harness's reduction does)."""
    from harness.trace import WINDOW, _on_device, _union, reduce_events

    mirrored = reduce_events(events)
    base = reduce_events([e for e in events
                          if not (_on_device(e) and _is_port(e.name))])
    win = [e for e in events if e.name == WINDOW and not _on_device(e)][0]
    w0, w1 = win.time_range.start, win.time_range.end
    dev = []
    for e in events:
        if (_on_device(e) and not e.name.startswith("bench.")
                and not _is_port(e.name)):
            a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if b > a:
                dev.append((a, b))
    busy = _union(dev)
    host = [(e.time_range.start, e.time_range.end, e.name, e.thread)
            for e in events if not _on_device(e) and e.name != WINDOW
            and (e.name.startswith("bench.") or _is_port(e.name))]
    gaps: Dict[str, float] = {}
    by_span: Dict[str, float] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    idle = labelled = 0.0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid, sec = 0.5 * (a + b), (b - a) * 1e-6
        open_ = [(e - s, n, t) for s, e, n, t in host if s <= mid <= e]
        bench = [(n, t) for _, n, t in open_ if n.startswith("bench.")]
        label = " | ".join(sorted({n for n, _ in bench})) or "bench.none"
        threads = {t for _, t in bench}
        port = sorted((d, n) for d, n, t in open_ if _is_port(n)
                      and (not threads or t in threads))
        if port:
            label += " > " + port[0][1]
            by_span[port[0][1]] = by_span.get(port[0][1], 0.0) + sec
            labelled += sec
        idle += sec
        gaps[label] = gaps.get(label, 0.0) + sec
    return {"window_s": base["window_s"], "busy_s": base["busy_s"],
            "idle_share": 100.0 * (1.0 - base["busy_s"] / base["window_s"]),
            "device_ops": base["device_ops"],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                key=lambda kv: -kv[1])[:10],
            "idle_by_span": dict(sorted(by_span.items(),
                                        key=lambda kv: -kv[1])),
            "port_labelled_share": (100.0 * labelled / idle if idle
                                    else None),
            "idle_share_mirrored": 100.0 * (1.0 - mirrored["busy_s"]
                                            / mirrored["window_s"])}


# ----------------------------------------------------------------- the run
class SyncLog:
    """Operations that synchronised with the device, by the innermost
    port span open on their thread (``set_sync_debug_mode("warn")``)."""

    def __init__(self):
        self.by_span: Counter = Counter()
        self._show = None

    def __enter__(self):
        import torch

        from repro_torch import trace

        def show(message, category, *args, **kwargs):
            if "synchronizing" in str(message):
                self.by_span[trace.current() or "none"] += 1
            else:
                self._show(message, category, *args, **kwargs)

        self._show = warnings.showwarning
        warnings.showwarning = show
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode("default")
        warnings.showwarning = self._show
        return False


def run(files: dict, seed: int, seconds: float, spans_on: bool,
        profile: bool, sync_debug: bool, device="cuda") -> dict:
    """Set-up, the window with the port's spans on (``spans_on``) from
    set-up's end, and the readings (no comparison with the reference)."""
    import torch

    from harness import trace as htrace
    from harness.cell import make_cell, reader
    from repro_torch import trace

    events: list = []
    if profile:
        reduce = htrace.reduce_events

        def keep(evs):
            events.extend(evs)
            return reduce(evs)

        htrace.reduce_events = keep
    cell = make_cell(files, seed, seconds, profile, device)
    cell.setup()
    rec = cell.rec
    setup_s = time.perf_counter() - T_START
    before = trace.counters()
    trace.spans()
    if spans_on:
        trace.enable(cell.clock)
    syncs = SyncLog() if sync_debug else None
    try:
        with syncs or contextlib.nullcontext():
            cell.window()
            cell.close()
    finally:
        trace.disable()
        if profile:
            htrace.reduce_events = reduce
    spans = trace.spans()
    out = {"workload": files["cell"]["name"], "seed": seed,
           "spans_on": spans_on, "setup_s": setup_s,
           "device": (torch.cuda.get_device_name(0)
                      if torch.device(device).type == "cuda" else "cpu"),
           "bench": {k: reader(k, files["root"] / "bench")(rec)
                     for k in BENCH_READERS},
           "spans": span_readings(spans, rec),
           "n_spans": len(spans),
           "migrations": migration_phases(spans, rec),
           "counters": counter_deltas(before, trace.counters())}
    if events:
        out["trace"] = reduce_labelled(events)
    if syncs is not None:
        out["syncs_by_span"] = dict(syncs.by_span)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=0)
    ap.add_argument("--sync-debug", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    from harness.common import cell_files, set_cache_env

    set_cache_env()
    import torch

    if not torch.cuda.is_available():
        print("trace_torch_bench: torch finds no CUDA card", file=sys.stderr)
        return 3
    out = run(cell_files(args.workload), args.seed, args.seconds,
              bool(args.spans), bool(args.profile), args.sync_debug)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
