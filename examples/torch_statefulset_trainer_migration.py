"""MS2M for a TRAINING worker with StatefulSet identity, through the
PyTorch/CUDA port (``examples/statefulset_trainer_migration.py``'s
configs, rates and printed lines): the FT/elasticity story.  A trainer
holding (params, optimizer state) is live-migrated across nodes via
checkpoint image + batch-journal replay; a straggler detector triggers the
migration.  The closing check folds the batch ids into a fresh trainer,
which must give the migrated trainer's bits (deterministic kernels).

  PYTHONPATH=src python examples/torch_statefulset_trainer_migration.py
  PYTHONPATH=src python examples/torch_statefulset_trainer_migration.py \
      --device cpu

Weights come from ``TrainerWorker``'s own draw (``init_lm``, seed 0);
without a CUDA card ``--device cuda`` (the default) raises.
"""
import argparse
import tempfile

from repro_torch import configs, resolve_device
from repro_torch.broker.broker import Message
from repro_torch.cluster.cluster import Cluster
from repro_torch.core.migration import MigrationManager
from repro_torch.core.trainer_worker import TrainerWorker
from repro_torch.data import DataConfig
from repro_torch.optim import adamw
from repro_torch.train import step as steplib


def trainer_migration(device):
    """A smoke smollm_360m trainer fed batch ids at 5/s, migrated at
    virtual t = 15 s by ``ms2m_statefulset`` -> (``MigrationReport``,
    whether a fresh trainer fed every batch id equals the target)."""
    cfg = configs.get_smoke("smollm_360m")
    tcfg = steplib.TrainStepConfig(
        remat="none", lr_peak=1e-3, warmup_steps=5, total_steps=10_000,
        opt=adamw.AdamWConfig(weight_decay=0.01))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4)

    def make_worker():
        return TrainerWorker(cfg, tcfg, dcfg, device=device)

    with tempfile.TemporaryDirectory() as tmp:
        cluster = Cluster(tmp, num_nodes=3)
        sim, api, broker = cluster.sim, cluster.api, cluster.broker
        broker.declare_queue("batches")

        # producer: the data-dispatcher emits batch ids at 5/s
        def producer():
            i = 0
            while sim.now < 300.0:
                yield 0.2
                broker.publish("batches", {"batch_id": i})
                i += 1

        sim.process(producer())

        worker = make_worker()
        holder = {}

        def boot():
            pod = yield from api.create_pod(
                "trainer-0", "node0", worker, broker.queues["batches"],
                statefulset_identity="trainer-0")
            pod.start()
            holder["pod"] = pod

        sim.process(boot())
        sim.run(until=15.0)
        pod = holder["pod"]
        print(f"[demo] trainer at virtual t=15s: step={worker.step} "
              f"loss={worker.last_loss:.3f}")

        # straggler detector: pretend node0 degraded -> live-migrate
        print("[demo] straggler detected on node0 -> MS2M StatefulSet "
              "migration to node1")
        mgr = MigrationManager(api, make_worker, "batches")
        done = mgr.migrate("ms2m_statefulset", pod, "node1",
                           statefulset_identity="trainer-0")
        sim.run(stop_when=done)
        report, target = done.value
        sim.run(until=sim.now + 10.0)
        print(f"[demo] migration done: migration_time="
              f"{report.migration_time:.2f}s downtime={report.downtime:.2f}s")
        print(f"[demo] target trainer resumed: step={target.worker.step} "
              f"loss={target.worker.last_loss:.3f}")
        print(f"[demo] image bytes written {report.image_written_bytes/1e6:.1f}MB"
              f" (deduped {report.image_deduped_bytes/1e6:.1f}MB)")

        # verification: fold all batch ids into a fresh trainer
        ref = make_worker()
        for i in range(target.worker.last_msg_id + 1):
            ref.process(Message(i, {"batch_id": i}, 0.0))
        fold_equal = ref.state_equal(target.worker)
        print(f"[demo] replayed reference fold matches migrated trainer: "
              f"{fold_equal}")
    return report, fold_equal


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda runs the CUDA kernels; cpu "
                         "their plain versions)")
    trainer_migration(resolve_device(ap.parse_args(argv).device))


if __name__ == "__main__":
    main()
