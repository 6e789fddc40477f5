"""Live migration of a serving replica under load — paper Figs. 6-7 as a
runnable demo through the PyTorch/CUDA port, with a REAL consumer
(KV-cache state), comparing all four strategies and showing the
beyond-paper batched-replay + registry-dedup effects
(``examples/live_migration_serving.py``'s rates and printed lines).

  PYTHONPATH=src python examples/torch_live_migration_serving.py
  PYTHONPATH=src python examples/torch_live_migration_serving.py --device cpu

Weights come from ``make_torch_worker_factory``'s draw (``init_lm``, seed
0); without a CUDA card ``--device cuda`` (the default) raises.
"""
import argparse
import tempfile

from repro_torch import resolve_device
from repro_torch.core import (
    make_torch_worker_factory,
    measure_replay_speedup,
    run_migration_experiment,
)

STRATEGIES = ("stop_and_copy", "ms2m_individual", "ms2m_cutoff",
              "ms2m_statefulset")


def replay_speedup(make_worker, cfg) -> float:
    """The measured wall-clock speedup of chunk-parallel replay over
    per-message decode (128 messages, max_seq 512)."""
    worker = make_worker()  # builds + caches the params
    speedup = measure_replay_speedup(cfg, worker.params, n=128, max_seq=512)
    print(f"[demo] measured chunk-parallel replay speedup: {speedup:.1f}x")
    return speedup


def sweep(make_worker, rate, root):
    """Every strategy of ``STRATEGIES`` at ``rate`` msg/s -> {strategy:
    ``ExperimentResult``}."""
    results = {}
    for strategy in STRATEGIES:
        r = run_migration_experiment(
            strategy, rate, registry_root=f"{root}/{strategy}",
            worker_factory=make_worker, seed=0)
        phases = ", ".join(f"{k}={v:.1f}s"
                           for k, v in r.report.phases.items())
        print(f"  {strategy:18s} migration={r.migration_time:7.2f}s "
              f"downtime={r.downtime:6.2f}s verified={r.verified}")
        print(f"      phases: {phases}")
        print(f"      image: wrote {r.report.image_written_bytes/1e6:.1f}MB"
              f" (deduped {r.report.image_deduped_bytes/1e6:.1f}MB)")
        results[strategy] = r
    return results


def batched_pair(make_worker, speedup, root):
    """``ms2m_cutoff`` at 16 msg/s, paper-faithful (sequential replay, the
    cutoff fires) and with batched replay at ``speedup`` -> {label:
    ``ExperimentResult``}."""
    results = {}
    for label, batched in (("paper-faithful", False), ("batched", True)):
        r = run_migration_experiment(
            "ms2m_cutoff", 16.0, registry_root=f"{root}/b{batched}",
            worker_factory=make_worker, seed=0,
            batched_replay=batched, replay_speedup=speedup)
        print(f"  {label:15s} migration={r.migration_time:7.2f}s "
              f"downtime={r.downtime:6.2f}s cutoff_fired="
              f"{r.report.cutoff_fired} verified={r.verified}")
        results[label] = r
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda runs the CUDA kernels; cpu "
                         "their plain versions)")
    device = resolve_device(ap.parse_args(argv).device)
    make_worker, cfg = make_torch_worker_factory(max_seq=2048, device=device)
    speedup = replay_speedup(make_worker, cfg)

    rate = 10.0
    print(f"[demo] message rate λ={rate}/s, μ=20/s (paper intermediate)")
    with tempfile.TemporaryDirectory() as tmp:
        sweep(make_worker, rate, tmp)
        # beyond-paper: batched replay at high rate
        print("[demo] beyond-paper batched replay at λ=16/s:")
        batched_pair(make_worker, speedup, tmp)


if __name__ == "__main__":
    main()
