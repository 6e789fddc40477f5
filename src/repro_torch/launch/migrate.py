"""Migration driver CLI — the Migration Manager as an operator command.

  PYTHONPATH=src python -m repro_torch.launch.migrate \
      --strategy ms2m_cutoff --rate 12 --batched-replay --device cuda

Port of ``repro.launch.migrate``.  Runs the full fold workload (producer
-> consumer pod -> migration -> verify) on the virtual-time cluster with
the real paper-consumer model on ``--device`` (``cuda`` by default: the
decode-attention and chunk-fingerprint kernels run on the card) and
prints the MigrationReport (phases, downtime, image bytes,
verification).

The flags are the reference's.  ``--workload serving|rebalance`` and the
``xor_rle``/``int8``/``auto`` codecs are not ported yet: asking for them
exits with status 2 and says so.

The strategy list comes from the registry, so operator-registered schemes
(imported via ``--strategy-module``) are drivable without touching this
file.
"""
from __future__ import annotations

import argparse
import importlib
import json
import tempfile

import sys

from repro_torch.cluster import (FAULT_KINDS, available_topologies, parse_fault,
                           topology_entries)
from repro_torch.core import (
    MigrationPolicy,
    available_strategies,
    make_torch_worker_factory,
    measure_replay_speedup,
    registry_entries,
    run_migration_experiment,
)


def list_topologies() -> int:
    """Print every network topology preset with its docstring summary."""
    for row in topology_entries():
        print(f"{row['name']:12s} {row['summary']}")
    return 0


def list_strategies() -> int:
    """Print every registered strategy with its control-plane flags and
    docstring summary (operator-registered schemes included when imported
    via ``--strategy-module``)."""
    for row in registry_entries():
        flags = [f for f, on in (("wants_cutoff", row["wants_cutoff"]),
                                 ("handles_identity",
                                  row["handles_identity"])) if on]
        print(f"{row['name']:20s} [{', '.join(flags) or '-'}]")
        print(f"    {row['summary']}")
    return 0


def main(argv=None) -> int:
    # pre-parse --strategy-module on a separate help-less parser so custom
    # schemes register before --strategy choices are validated, without
    # swallowing -h/--help or prefix-matching --strategy
    module_help = ("import this module first (for @register_strategy side "
                   "effects) so custom schemes are available")
    pre_ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    pre_ap.add_argument("--strategy-module", default=None)
    pre, _ = pre_ap.parse_known_args(argv)
    if pre.strategy_module:
        importlib.import_module(pre.strategy_module)

    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--strategy-module", default=None, help=module_help)
    ap.add_argument("--list-strategies", action="store_true",
                    help="print registry entries (name, wants_cutoff/"
                         "handles_identity flags, docstring) and exit")
    ap.add_argument("--strategy", default="ms2m_individual",
                    choices=available_strategies())
    ap.add_argument("--topology", default="flat",
                    choices=available_topologies(),
                    help="network topology preset the cluster runs over "
                         "(flat = the uncontended seed model)")
    ap.add_argument("--list-topologies", action="store_true",
                    help="print the topology presets and exit")
    ap.add_argument("--workload", default="fold",
                    choices=("fold", "serving", "rebalance"),
                    help="fold = the paper's consumer workload; serving = "
                         "open-loop request stream against a slot-based "
                         "serving worker with latency tracing and the "
                         "exactly-once completion audit; rebalance = an "
                         "N-pod fleet under faults, reactive by default "
                         "(add --controller for the predictive rebalancer)")
    ap.add_argument("--rate", type=float, default=10.0,
                    help="arrival rate (msgs/s, or req/s with "
                         "--workload serving)")
    ap.add_argument("--num-slots", type=int, default=8,
                    help="decode slots of the serving worker "
                         "(--workload serving)")
    ap.add_argument("--decode-rounds", type=int, default=1,
                    help="decode rounds per admission for the serving "
                         "engine: generation spans messages "
                         "(--workload serving without --hash-consumer)")
    ap.add_argument("--processing-ms", type=float, default=50.0)
    ap.add_argument("--t-replay-max", type=float, default=45.0)
    ap.add_argument("--registry", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hash-consumer", action="store_true",
                    help="cheap fold worker instead of the model")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model consumer (cuda runs "
                         "the CUDA kernels; cpu their plain versions)")
    ap.add_argument("--batched-replay", action="store_true")
    ap.add_argument("--precopy", action="store_true",
                    help="iterative delta pre-copy transfer engine")
    ap.add_argument("--precopy-max-rounds", type=int, default=5)
    ap.add_argument("--compression", default="none",
                    choices=("none", "xor_rle", "int8", "auto"),
                    help="delta codec for pre-copy rounds (wire bytes)")
    ap.add_argument("--events", action="store_true",
                    help="also print the structured MigrationEvent trace")
    ap.add_argument("--fault", action="append", default=[],
                    metavar="KIND@TRIGGER[,k=v,...]",
                    help="inject a fault (repeatable), e.g. "
                         "node_flap@12,node=node1,duration=5 or "
                         "registry_outage@precopy_round:1,duration=8; "
                         "kinds: " + ", ".join(FAULT_KINDS))
    # -- rebalance workload: the predictive controller and its knobs ------
    ap.add_argument("--controller", action="store_true",
                    help="enable the predictive RebalanceController "
                         "(--workload rebalance; off = reactive baseline)")
    ap.add_argument("--controller-tick", type=float, default=1.0,
                    help="control-loop period, virtual seconds")
    ap.add_argument("--controller-horizon", type=float, default=30.0,
                    help="messages-at-risk exposure cap (s)")
    ap.add_argument("--controller-suspect", type=float, default=90.0,
                    help="how long a flapped node stays suspect (s)")
    ap.add_argument("--controller-cooldown", type=float, default=30.0,
                    help="per-queue quiet period after a move (s)")
    ap.add_argument("--controller-max-moves", type=int, default=2,
                    help="new migrations admitted per control tick")
    ap.add_argument("--controller-min-risk", type=float, default=0.25,
                    help="combined risk below which pods are ignored")
    ap.add_argument("--controller-min-score", type=float, default=1e-9,
                    help="messages-at-risk per byte admission bar")
    ap.add_argument("--arrival-schedule", default="steady",
                    choices=("steady", "diurnal", "flash_crowd"),
                    help="arrival-rate modulation of the rebalance fleet")
    ap.add_argument("--n-pods", type=int, default=6,
                    help="fleet size (--workload rebalance)")
    ap.add_argument("--num-nodes", type=int, default=4,
                    help="cluster size (--workload rebalance)")
    ap.add_argument("--t-end", type=float, default=150.0,
                    help="scenario length, virtual s (--workload rebalance)")
    ap.add_argument("--max-attempts", type=int, default=1,
                    help="migration attempts before giving up (failed "
                         "attempts are rolled back: source serving again)")
    ap.add_argument("--retry-backoff", type=float, default=2.0,
                    help="seconds between migration attempts")
    args = ap.parse_args(argv)

    if args.list_strategies:
        return list_strategies()
    if args.list_topologies:
        return list_topologies()

    not_ported = []
    if args.workload != "fold":
        not_ported.append(f"--workload {args.workload}")
    if args.compression != "none":
        not_ported.append(f"--compression {args.compression}")
    if not_ported:
        print(f"[migrate] {', '.join(not_ported)}: not ported yet to "
              "repro_torch (the reference package runs it: python -m "
              "repro.launch.migrate)", file=sys.stderr)
        return 2

    worker_factory = None
    speedup = 1.0
    if not args.hash_consumer:
        worker_factory, cfg = make_torch_worker_factory(
            max_seq=2048, device=args.device)
        if args.batched_replay:
            w = worker_factory()
            speedup = measure_replay_speedup(cfg, w.params, n=128,
                                             max_seq=512)
            print(f"[migrate] measured replay speedup: {speedup:.1f}x")

    policy = MigrationPolicy(
        batched_replay=args.batched_replay,
        replay_speedup=speedup if args.batched_replay else 1.0,
        precopy=args.precopy,
        precopy_max_rounds=args.precopy_max_rounds,
        compression=args.compression,
        t_replay_max=args.t_replay_max,
        max_attempts=args.max_attempts,
        retry_backoff_s=args.retry_backoff,
    )
    faults = [parse_fault(spec) for spec in args.fault] or None
    registry = args.registry or tempfile.mkdtemp(prefix="repro-registry-")
    r = run_migration_experiment(
        args.strategy, args.rate, registry_root=registry,
        processing_ms=args.processing_ms, t_replay_max=args.t_replay_max,
        seed=args.seed, worker_factory=worker_factory, policy=policy,
        topology=args.topology, faults=faults,
        allow_failure=faults is not None)
    print(json.dumps(r.row(), indent=2))
    if r.failed:
        print(f"[migrate] FAILED after {r.failure.get('attempts')} "
              f"attempt(s): {r.failure.get('error')} "
              f"(rolled back: source_serving="
              f"{r.failure.get('source_serving')})")
        return 1
    if args.events:
        print(json.dumps(r.report.event_rows(), indent=2))
    print(f"[migrate] downtime={r.downtime:.2f}s "
          f"migration={r.migration_time:.2f}s verified={r.verified} "
          f"attempts={r.report.attempts}")
    return 0 if r.verified else 1


if __name__ == "__main__":
    raise SystemExit(main())
