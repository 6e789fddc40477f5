"""Elastic scaling of partitioned stateful services (paper §III-C).

The paper notes that stateful K8s services partition work: "a message queue
might be partitioned based on certain keys, with each partition assigned to
a specific instance", often with a dedicated queue per instance.  That
structure is what makes *elastic scaling* an MS2M problem: scaling out
moves bucket ownership, and the new owner must reconstruct each moved
bucket's state — which is, again, a fold of that bucket's message sub-log.

  scale_out:  new instance claims buckets -> bootstraps them by replaying
              the per-bucket journal -> router flips ownership.  Only the
              moved buckets pause (bounded by Eq. 5 applied per bucket);
              the rest of the fleet never stops.

``BucketedConsumer`` keeps one fold per bucket, so bucket state is exactly
separable (the property real partitioned services have by construction).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Generator, List, Optional

import numpy as np

from repro_torch.broker.broker import Broker, Message
from repro_torch.checkpoint.registry import Registry
from repro_torch.core.journal import Journal


def bucket_of(key: int, num_buckets: int) -> int:
    return int(np.uint64(key * 2654435761) % np.uint64(num_buckets))


class BucketedConsumer:
    """Per-bucket fold state (drop-in worker for Pod)."""

    def __init__(self, buckets: List[int], num_buckets: int,
                 name: str = "bucketed"):
        self.num_buckets = num_buckets
        self.owned = set(buckets)
        self.digests: Dict[int, np.uint64] = {
            b: np.uint64(1469598103934665603) for b in buckets}
        self.counts: Dict[int, int] = {b: 0 for b in buckets}
        self.last_msg_id = -1
        self.n_processed = 0
        self.skip_until = -1
        self.name = name

    def process(self, msg) -> None:
        key = int(msg.payload["key"])
        b = bucket_of(key, self.num_buckets)
        if b in self.owned:
            with np.errstate(over="ignore"):
                x = np.uint64(msg.payload["token"]) ^ np.uint64(msg.msg_id + 1)
                self.digests[b] = np.uint64(
                    (self.digests[b] ^ x) * np.uint64(1099511628211))
            self.counts[b] += 1
            self.n_processed += 1
        self.last_msg_id = msg.msg_id

    # bucket state transfer ---------------------------------------------
    def export_buckets(self, buckets: List[int]) -> Dict[int, tuple]:
        return {b: (np.uint64(self.digests[b]), self.counts[b])
                for b in buckets if b in self.owned}

    def drop_buckets(self, buckets: List[int]):
        for b in buckets:
            self.owned.discard(b)
            self.digests.pop(b, None)
            self.counts.pop(b, None)

    def adopt_buckets(self, states: Dict[int, tuple]):
        for b, (digest, count) in states.items():
            self.owned.add(b)
            self.digests[b] = np.uint64(digest)
            self.counts[b] = int(count)

    def state_tree(self):
        items = sorted(self.digests.items())
        return {
            "buckets": np.asarray([b for b, _ in items], np.int64),
            "digests": np.asarray([d for _, d in items], np.uint64),
            "counts": np.asarray([self.counts[b] for b, _ in items], np.int64),
            "scalars": {"last_msg_id": np.int64(self.last_msg_id),
                        "n_processed": np.int64(self.n_processed)},
        }

    def load_state(self, tree):
        self.owned = set(int(b) for b in tree["buckets"])
        self.digests = {int(b): np.uint64(d)
                        for b, d in zip(tree["buckets"], tree["digests"])}
        self.counts = {int(b): int(c)
                       for b, c in zip(tree["buckets"], tree["counts"])}
        self.last_msg_id = int(tree["scalars"]["last_msg_id"])
        self.n_processed = int(tree["scalars"]["n_processed"])


class PartitionedService:
    """Router + N bucketed instances with dedicated queues + journals."""

    def __init__(self, cluster, name: str, num_buckets: int = 64,
                 num_instances: int = 2):
        self.cluster = cluster
        self.name = name
        self.num_buckets = num_buckets
        self.ownership: Dict[int, int] = {}  # bucket -> instance idx
        self.queues: List = []
        self.journals: List[Journal] = []
        self.pods: List = []
        self.workers: List[BucketedConsumer] = []
        self._n = num_instances
        for i in range(num_instances):
            self._add_instance_structs(i)
        for b in range(num_buckets):
            self.ownership[b] = b % num_instances

    def _add_instance_structs(self, i: int):
        q = self.cluster.broker.declare_queue(f"{self.name}.p{i}")
        self.queues.append(q)
        self.journals.append(Journal(self.cluster.registry, f"{self.name}.p{i}"))

    def boot(self) -> Generator:
        for i in range(self._n):
            buckets = [b for b, o in self.ownership.items() if o == i]
            worker = BucketedConsumer(buckets, self.num_buckets,
                                      name=f"{self.name}-{i}")
            node = f"node{i % len(self.cluster.api.nodes)}"
            pod = yield from self.cluster.api.create_pod(
                f"{self.name}-{i}", node, worker, self.queues[i],
                statefulset_identity=f"{self.name}-{i}")
            pod.start()
            self.pods.append(pod)
            self.workers.append(worker)

    # routing ---------------------------------------------------------------
    def publish(self, key: int, token: int):
        b = bucket_of(key, self.num_buckets)
        i = self.ownership[b]
        msg = self.cluster.broker.publish(f"{self.name}.p{i}",
                                          {"key": key, "token": token})
        # per-instance journals are independent logs (ids are per-queue)
        self.journals[i].append(msg)
        return msg

    # elastic scale-out -------------------------------------------------------
    def scale_out(self, target_node: str) -> Generator:
        """Add instance N: it claims ~1/(N+1) of every instance's buckets,
        bootstrapped by direct bucket-state transfer from the donors
        (per-bucket folds are separable), then the router flips ownership.
        Donors keep serving untouched buckets throughout."""
        api = self.cluster.api
        new_idx = len(self.pods)
        self._add_instance_structs(new_idx)
        # choose buckets to move (round-robin steal)
        moving: Dict[int, List[int]] = {}
        for b in range(self.num_buckets):
            if b % (new_idx + 1) == new_idx:
                donor = self.ownership[b]
                moving.setdefault(donor, []).append(b)
        worker = BucketedConsumer([], self.num_buckets,
                                  name=f"{self.name}-{new_idx}")
        pod = yield from api.create_pod(
            f"{self.name}-{new_idx}", target_node, worker,
            self.queues[new_idx],
            statefulset_identity=f"{self.name}-{new_idx}")
        t = api.timings
        for donor, buckets in moving.items():
            moved = set(buckets)
            # 1) flip the router first: new arrivals buffer in the new
            #    queue (its pod is not started yet), closing the race
            for b in buckets:
                self.ownership[b] = new_idx
            yield t.route_switch_s
            # 2) drain the donor's backlog + in-flight message for moved
            #    buckets — event-driven, not a busy-poll [SIM004]: wait on
            #    the donor's on_processed events and re-check after each,
            #    so the drain contributes zero sim events beyond the
            #    donor's own service completions
            donor_q = self.queues[donor]
            donor_pod = self.pods[donor]

            def _moved_pending() -> bool:
                if any(bucket_of(int(m.payload["key"]), self.num_buckets)
                       in moved for m in donor_q._items):
                    return True
                inflight = donor_pod.in_flight
                return (inflight is not None
                        and bucket_of(int(inflight.payload["key"]),
                                      self.num_buckets) in moved)

            while _moved_pending():
                drained = api.sim.condition(f"{self.name}:drain")

                def _on_proc(_pod, _msg, cond=drained):
                    cond.trigger()

                donor_pod.add_on_processed(_on_proc)
                try:
                    yield drained
                finally:
                    donor_pod.remove_on_processed(_on_proc)
            # 3) transfer the (separable) bucket folds
            states = self.workers[donor].export_buckets(buckets)
            self.workers[donor].drop_buckets(buckets)
            worker.adopt_buckets(states)
        pod.start()
        self.pods.append(pod)
        self.workers.append(worker)
        return pod

    # verification ------------------------------------------------------------
    def reference_fold(self, published: List[tuple]) -> Dict[int, np.uint64]:
        """Fold every published (queue_msg_id, key, token) per bucket."""
        digests = {b: np.uint64(1469598103934665603)
                   for b in range(self.num_buckets)}
        for msg_id, key, token in published:
            b = bucket_of(key, self.num_buckets)
            with np.errstate(over="ignore"):
                x = np.uint64(token) ^ np.uint64(msg_id + 1)
                digests[b] = np.uint64((digests[b] ^ x) * np.uint64(1099511628211))
        return digests
