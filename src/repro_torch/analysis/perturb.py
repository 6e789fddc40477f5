"""Virtual-time schedule perturbation: the latent-race detector.

``Sim(tiebreak_seed=N)`` permutes the pop order of *equal-timestamp* heap
events (a bijective splitmix64 hash of the event counter — virtual time
itself never changes).  A correct simulation must not care which of two
events at the same instant runs first unless it explicitly ordered them;
so any run whose *observable result* changes under a tie-break seed has a
latent scheduling race — exactly the class of bug a lucky heap order
hides until a refactor reshuffles event insertion.

Two sweeps (the port's copy of ``repro.analysis.perturb``; the JAX
package's are run by ``tools/sim_perturb.py``, the CI ``sim-perturb`` job):

  * **regression sweep** (hard gate) — the flat-topology single-pod
    migration experiment for each built-in strategy, run unperturbed and
    under K tie-break seeds; every ``ExperimentResult.row()`` must be
    bit-identical to the unperturbed baseline (concurrency is 1 and the
    timeline is float-timed, so nothing may legitimately reorder);
  * **chaos sweep** (invariant gate) — seeded fault-schedule fleet runs
    under each tie-break seed; retries and fair-share flows may reorder
    legitimately, but the crash-consistency invariant (every completed
    migration state-verified, every failure rolled back with the source
    serving) must hold under every permutation.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Dict, Iterable, List, Optional, Sequence

_TIEBREAK_ENV = "REPRO_SIM_TIEBREAK"

DEFAULT_TIEBREAK_SEEDS = (1, 2, 3, 4, 5)
REGRESSION_STRATEGIES = ("ms2m_individual", "ms2m_precopy",
                         "ms2m_statefulset")


def canon(row: Dict) -> str:
    """Canonical byte-stable form of a result row for bit-identity
    comparison."""
    return json.dumps(row, sort_keys=True)


@contextlib.contextmanager
def tiebreak(seed: Optional[int]):
    """Set the process-wide tie-break seed for every ``Sim`` constructed
    inside the block (the experiment entry points build their own
    ``Cluster``/``Sim``, so the env fallback is the plumbing)."""
    prev = os.environ.get(_TIEBREAK_ENV)
    try:
        if seed is None:
            os.environ.pop(_TIEBREAK_ENV, None)
        else:
            os.environ[_TIEBREAK_ENV] = str(seed)
        yield
    finally:
        if prev is None:
            os.environ.pop(_TIEBREAK_ENV, None)
        else:
            os.environ[_TIEBREAK_ENV] = prev


def regression_row(strategy: str, *, tiebreak_seed: Optional[int] = None,
                   message_rate: float = 8.0, seed: int = 0) -> Dict:
    """One flat-topology single-pod migration experiment; returns its
    result row."""
    from repro_torch.core.workload import run_migration_experiment

    with tempfile.TemporaryDirectory() as root, tiebreak(tiebreak_seed):
        res = run_migration_experiment(strategy, message_rate,
                                       registry_root=root, seed=seed)
    return res.row()


def perturb_regressions(
        tiebreak_seeds: Sequence[int] = DEFAULT_TIEBREAK_SEEDS,
        strategies: Iterable[str] = REGRESSION_STRATEGIES,
        message_rate: float = 8.0, seed: int = 0) -> Dict:
    """The hard bit-identity gate: every strategy's flat-topology timeline
    row must match the unperturbed baseline under every tie-break seed."""
    cells: List[Dict] = []
    for strategy in strategies:
        base = canon(regression_row(strategy, tiebreak_seed=None,
                                    message_rate=message_rate, seed=seed))
        divergent = []
        for ts in tiebreak_seeds:
            row = canon(regression_row(strategy, tiebreak_seed=ts,
                                       message_rate=message_rate, seed=seed))
            if row != base:
                divergent.append(ts)
        cells.append({"strategy": strategy,
                      "tiebreak_seeds": list(tiebreak_seeds),
                      "divergent_seeds": divergent,
                      "bit_identical": not divergent})
    return {"sweep": "regression", "ok": all(c["bit_identical"]
                                             for c in cells),
            "cells": cells}


def chaos_run(scheme: str, seed: int, n_faults: int, *, n_pods: int = 2,
              num_nodes: int = 4) -> Dict:
    """One seeded fault-schedule fleet run and its crash-consistency
    invariant: every completed migration state-verified, every failure
    rolled back with its source serving and verified.  The port's copy of
    ``benchmarks/chaos.py``'s ``_run_one`` (a target-side-only schedule:
    faults hit the reserved target node, the registry, its link and the
    queues, never a source node)."""
    from repro_torch.cluster.faults import FaultSchedule
    from repro_torch.core import MigrationPolicy, run_fleet_experiment

    schedule = FaultSchedule.random(
        seed, n_faults=n_faults, t_window=(11.0, 70.0),
        nodes=(f"node{num_nodes - 1}",),
        queues=tuple(f"orders-{i}" for i in range(n_pods)))
    mode = "rolling" if scheme == "ms2m_statefulset" else "parallel"
    with tempfile.TemporaryDirectory() as root:
        fleet = run_fleet_experiment(
            n_pods, scheme, 8.0, registry_root=root, mode=mode,
            max_concurrent=2, seed=seed, num_nodes=num_nodes,
            faults=schedule, allow_failures=True,
            policy=MigrationPolicy(max_attempts=3, retry_backoff_s=1.0))
    ok = all(r.state_verified for r in fleet.reports)
    for f in fleet.failures:
        ok = ok and bool(f.get("rolled_back") and f.get("source_serving")
                         and f.get("source_verified"))
    return {"seed": seed, "row": fleet.row(), "invariant_ok": bool(ok),
            "schedule": schedule.rows()}


def perturb_chaos(tiebreak_seeds: Sequence[int] = DEFAULT_TIEBREAK_SEEDS,
                  chaos_seeds: Sequence[int] = (10_000, 10_001),
                  n_faults: int = 1) -> Dict:
    """The invariant gate: seeded fault-schedule fleet runs must keep the
    crash-consistency invariant under every tie-break permutation.
    (Rows may legitimately reorder here — retries re-place targets — so
    this gates on the invariant, not bit identity.)"""
    cells: List[Dict] = []
    for cs in chaos_seeds:
        broken = []
        for ts in tiebreak_seeds:
            with tiebreak(ts):
                out = chaos_run("ms2m_precopy", cs, n_faults)
            if not out["invariant_ok"]:
                broken.append(ts)
        cells.append({"chaos_seed": cs, "tiebreak_seeds": list(tiebreak_seeds),
                      "invariant_broken_seeds": broken,
                      "invariant_ok": not broken})
    return {"sweep": "chaos", "ok": all(c["invariant_ok"] for c in cells),
            "cells": cells}


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="sim-perturb",
        description="run the regression + chaos suites under tie-break "
                    "perturbation seeds and flag timeline/invariant "
                    "divergence as a latent scheduling race")
    ap.add_argument("--seeds", type=int, default=5,
                    help="number of tie-break seeds (default 5)")
    ap.add_argument("--skip-chaos", action="store_true",
                    help="regression bit-identity sweep only")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as JSON")
    args = ap.parse_args(argv)

    seeds = tuple(range(1, args.seeds + 1))
    reports = [perturb_regressions(seeds)]
    if not args.skip_chaos:
        reports.append(perturb_chaos(seeds))

    ok = all(r["ok"] for r in reports)
    if args.json:
        print(json.dumps({"ok": ok, "reports": reports}, indent=2))
    else:
        for r in reports:
            for cell in r["cells"]:
                label = cell.get("strategy") or f"chaos:{cell['chaos_seed']}"
                bad = (cell.get("divergent_seeds")
                       or cell.get("invariant_broken_seeds"))
                status = ("OK" if not bad
                          else f"RACE under tie-break seeds {bad}")
                print(f"[{r['sweep']:10s}] {label:24s} {status}")
        print(f"sim-perturb {'OK' if ok else 'FAILED'} "
              f"({len(seeds)} tie-break seeds)")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
