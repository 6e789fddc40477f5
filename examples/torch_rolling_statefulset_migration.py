"""Rolling migration of a 3-replica StatefulSet with sticky-identity
handoff, driven by the port's ClusterMigrationOrchestrator
(``examples/rolling_statefulset_migration.py``'s run and printed lines).

Each replica owns a dedicated queue (paper §III-C); replicas are moved one
at a time with ms2m_statefulset + iterative delta pre-copy, so replica k+1
waits for replica k's target to hold its identity, and each stop phase
replays only the last pre-copy round's traffic.  The replicas are
``HashConsumer``s: the run is control plane only and needs no device.

  PYTHONPATH=src python examples/torch_rolling_statefulset_migration.py
"""
import tempfile

from repro_torch.cluster.cluster import Cluster
from repro_torch.core import (
    ClusterMigrationOrchestrator,
    HashConsumer,
    MigrationPolicy,
    PodMigrationSpec,
)

N_REPLICAS = 3


def main():
    with tempfile.TemporaryDirectory() as reg:
        cluster = Cluster(reg, num_nodes=3)
        sim, api, broker = cluster.sim, cluster.api, cluster.broker
        stop = {"flag": False}
        sources = {}

        for i in range(N_REPLICAS):
            qname = f"orders-{i}"
            broker.declare_queue(qname)

            def producer(i=i, qname=qname):
                while not stop["flag"]:
                    yield 0.125  # 8 msg/s per replica
                    broker.publish(qname, {"token": (i * 131) % 997})

            sim.process(producer())

            def boot(i=i, qname=qname):
                pod = yield from api.create_pod(
                    f"consumer-{i}", f"node{i % 2}", HashConsumer(),
                    broker.queues[qname],
                    statefulset_identity=f"consumer-{i}")
                pod.start()
                sources[i] = pod

            sim.process(boot())

        sim.run(until=10.0)
        print(f"[rolling] {N_REPLICAS} replicas serving; identities:",
              dict(api.statefulsets.identities))

        orch = ClusterMigrationOrchestrator(
            api, HashConsumer, policy=MigrationPolicy(precopy=True))
        specs = [PodMigrationSpec(pod=sources[i], queue=f"orders-{i}",
                                  target_node="node2",
                                  identity=f"consumer-{i}")
                 for i in range(N_REPLICAS)]
        done = orch.rolling_statefulset(specs)
        sim.run(stop_when=done)
        fleet = done.value
        stop["flag"] = True
        sim.run(until=sim.now + 1.0)

        for rep, target in zip(fleet.reports, fleet.targets):
            print(f"[rolling] {target.name}: downtime={rep.downtime:.2f}s "
                  f"precopy_rounds={rep.precopy_rounds} "
                  f"replayed={rep.replayed_messages} "
                  f"span=({rep.t_start:.1f}..{rep.t_end:.1f})")
        print(f"[rolling] fleet: span={fleet.span:.1f}s "
              f"peak_concurrency={fleet.peak_concurrency} "
              f"(sequential handoff)")
        print("[rolling] identities after handoff:",
              dict(api.statefulsets.identities))


if __name__ == "__main__":
    main()
