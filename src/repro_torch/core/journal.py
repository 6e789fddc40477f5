"""Message journal: durable log enabling *exact* failure recovery.

The minimal FT flow (image restore + live-queue continuation) loses the
messages a dead worker consumed after its last checkpoint — they left the
queue but their effect died with the pod.  The journal closes that gap,
completing MS2M's recovery story:

    state(t) = fold(image_state, journal[image_marker+1 : t])

A ``JournaledQueue`` wraps a broker queue and appends every published
message to a registry-backed segment log (content-addressed, so identical
segments dedup).  ``recover()`` = pull image -> replay journal suffix ->
resume the live queue.  This is the training-fleet checkpoint/restart path
at 1000+ nodes: checkpoint interval trades registry bandwidth against
replay time via exactly Eq. 5 (cutoff.replay_time_bound).
"""
from __future__ import annotations

import json
from typing import Any, Callable, Dict, Generator, List, Optional

from repro_torch.broker.broker import Broker, Message, MessageQueue
from repro_torch.checkpoint.registry import Registry


class Journal:
    """Append-only message log persisted to the registry in segments."""

    def __init__(self, registry: Registry, name: str,
                 segment_size: int = 256):
        self.registry = registry
        self.name = name
        self.segment_size = segment_size
        self._buffer: List[Message] = []
        self._segments: List[str] = []  # chunk keys, in order
        self.last_id = -1

    def append(self, msg: Message):
        assert msg.msg_id == self.last_id + 1, (
            f"journal gap: {msg.msg_id} after {self.last_id}")
        self._buffer.append(msg)
        self.last_id = msg.msg_id
        if len(self._buffer) >= self.segment_size:
            self.flush()

    def flush(self):
        if not self._buffer:
            return
        blob = json.dumps(
            [(m.msg_id, m.payload, m.publish_time) for m in self._buffer]
        ).encode()
        key, _ = self.registry.store.put(blob)
        self._segments.append(key)
        self._buffer.clear()

    def replay_range(self, start_id: int, end_id: Optional[int] = None
                     ) -> List[Message]:
        """Messages with start_id <= id <= end_id (inclusive)."""
        msgs: List[Message] = []
        for key in self._segments:
            for mid, payload, t in json.loads(self.registry.store.get(key)):
                if mid >= start_id and (end_id is None or mid <= end_id):
                    msgs.append(Message(mid, payload, t))
        for m in self._buffer:
            if m.msg_id >= start_id and (end_id is None or m.msg_id <= end_id):
                msgs.append(m)
        return msgs


class JournaledQueue:
    """Publish-through wrapper: queue + journal stay in lockstep."""

    def __init__(self, broker: Broker, name: str, registry: Registry):
        self.broker = broker
        self.queue = broker.declare_queue(name)
        self.journal = Journal(registry, name)
        self.name = name

    def publish(self, payload: Any) -> Message:
        msg = self.broker.publish(self.name, payload)
        self.journal.append(msg)
        return msg


def recover_worker(api, registry: Registry, journal: Journal, tag: str,
                   make_worker: Callable[[], Any], target_node: str,
                   queue: MessageQueue, pod_name: str = "recovered"
                   ) -> Generator:
    """Cluster sub-process: restore latest image, replay the journal suffix,
    resume live consumption.  Returns the new pod; the recovered worker's
    state is the *exact* fold of the full log (tests assert equality)."""
    image_id = registry.resolve(tag)
    assert image_id is not None, f"no image tagged {tag}"
    worker = make_worker()
    # charge the pull to the node the pod recovers onto: its registry
    # link (WAN if the node is remote), its layer cache, its death abort
    meta = yield from api.pull_and_restore(image_id, worker,
                                           node_name=target_node)
    marker = int(meta.get("last_msg_id", -1))
    journal.flush()
    suffix = journal.replay_range(marker + 1)
    # replay is instantaneous in virtual time relative to service rate —
    # a real fleet replays at full step throughput (cf. batched replay)
    for m in suffix:
        if m.msg_id > worker.last_msg_id:
            worker.process(m)
    worker.skip_until = worker.last_msg_id
    pod = yield from api.create_pod(pod_name, target_node, worker, queue)
    pod.start()
    return pod
