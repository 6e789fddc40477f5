"""Live migration of a continuous-batching SERVING ENGINE, through the
PyTorch/CUDA port (``examples/serving_engine_migration.py``'s config,
rates and printed lines).

The engine (slot KV caches + slot table) is itself an MS2M worker: its
message log is the admitted request stream.  We serve traffic, migrate the
whole engine with MS2M-individual, and verify the migrated engine equals an
uninterrupted reference fold.

  PYTHONPATH=src python examples/torch_serving_engine_migration.py
  PYTHONPATH=src python examples/torch_serving_engine_migration.py --device cpu

Weights come from ``init_lm``'s draw from seed 0; without a CUDA card
``--device cuda`` (the default) raises.
"""
import argparse
import tempfile

from repro_torch import configs, resolve_device
from repro_torch.core import run_migration_experiment
from repro_torch.models import transformer as T
from repro_torch.serving import ServingEngine


def engine_migration(device):
    """The paper consumer's smoke config served by a 2-slot engine, which
    MS2M-individual migrates at 3 req/s -> ``ExperimentResult``."""
    cfg = configs.get_smoke("paper_consumer")
    params = T.init_lm(cfg, seed=0, device=device)

    def make_engine():
        return ServingEngine(cfg, params, num_slots=2, max_seq=128)

    with tempfile.TemporaryDirectory() as reg:
        r = run_migration_experiment(
            "ms2m_individual", message_rate=3.0, registry_root=reg,
            worker_factory=make_engine, seed=0, processing_ms=120.0,
            t_migrate=6.0, settle_time=3.0)
    print(f"[demo] engine migration: migration_time={r.migration_time:.2f}s "
          f"downtime={r.downtime:.2f}s")
    print(f"[demo] requests served by target engine: "
          f"{r.processed_by_target}")
    print(f"[demo] migrated engine state verified: {r.verified}")
    print(f"[demo] image: wrote {r.report.image_written_bytes/1e6:.2f}MB "
          f"(KV slots + slot table)")
    return r


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda runs the CUDA kernels; cpu "
                         "their plain versions)")
    engine_migration(resolve_device(ap.parse_args(argv).device))


if __name__ == "__main__":
    main()
