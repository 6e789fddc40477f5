"""The port's message journal (``repro_torch.core.journal``) against the JAX
package's: the same segment log and replay ranges, and an exact recovery
after a node kill with the same recovered state, message ids and virtual
times in both packages."""
import importlib

import pytest


def _mods(pkg):
    return {name: importlib.import_module(f"{pkg}.{name}") for name in (
        "broker.broker", "cluster.cluster", "core", "core.journal",
        "checkpoint")}


PKGS = ("repro", "repro_torch")


def _replay_range(pkg, root):
    m = _mods(pkg)
    Message = m["broker.broker"].Message
    reg = m["checkpoint"].Registry(str(root))
    j = m["core.journal"].Journal(reg, "q", segment_size=4)
    for i in range(11):
        j.append(Message(i, {"token": i * 3}, 0.0))
    ids = [msg.msg_id for msg in j.replay_range(3, 9)]
    j.flush()
    first = j.replay_range(0)[0].payload
    return ids, first, len(j.replay_range(0))


def test_journal_replay_range_identical(tmp_path):
    got = _replay_range("repro_torch", tmp_path / "t")
    assert got == ([3, 4, 5, 6, 7, 8, 9], {"token": 0}, 11)
    assert got == _replay_range("repro", tmp_path / "j")


def _recovery(pkg, root):
    """The reference test's scenario: a journaled queue at 4 msg/s, images
    every 3 s, node0 killed at t=30, recovery onto node1 from the last
    image plus the journal suffix.  -> what it observed."""
    m = _mods(pkg)
    Message = m["broker.broker"].Message
    HashConsumer = m["core"].HashConsumer
    jr = m["core.journal"]
    cluster = m["cluster.cluster"].Cluster(str(root / "reg"), num_nodes=2)
    sim, api = cluster.sim, cluster.api
    jq = jr.JournaledQueue(cluster.broker, "orders", cluster.registry)
    worker = HashConsumer()
    holder = {}

    def boot():
        pod = yield from api.create_pod("c0", "node0", worker, jq.queue)
        pod.start()
        holder["pod"] = pod

    sim.process(boot())
    published = []

    def producer():
        i = 0
        while sim.now < 120.0:
            yield 0.25
            jq.publish({"token": (i * 17) % 997})
            published.append((i * 17) % 997)
            i += 1

    sim.process(producer())

    def checkpointer():
        while sim.now < 120.0:
            pod = holder.get("pod")
            if pod and not pod.deleted:
                ckpt = yield from api.checkpoint_pod(pod)
                yield from api.build_and_push_image(ckpt, "ft")
            yield 3.0

    sim.process(checkpointer())
    sim.run(until=30.0)
    killed_at = (worker.last_msg_id, worker.n_processed)
    api.kill_node("node0")
    rec = sim.process(jr.recover_worker(
        api, cluster.registry, jq.journal, "ft", lambda: HashConsumer(),
        "node1", jq.queue, "c0-recovered"))
    sim.run(until=100.0)
    nw = rec.value.worker
    ref = HashConsumer()
    for i, tok in enumerate(published[: nw.last_msg_id + 1]):
        ref.process(Message(i, {"token": tok}, 0.0))
    return {"killed_at": killed_at, "last_msg_id": nw.last_msg_id,
            "n_processed": nw.n_processed, "published": len(published),
            "exact": ref.state_equal(nw), "now": sim.now,
            "state": repr(nw.state_tree())}


def test_exact_recovery_after_node_kill_identical(tmp_path):
    got = _recovery("repro_torch", tmp_path / "t")
    assert got["exact"], "journaled recovery diverged from the full fold"
    assert got["last_msg_id"] > got["killed_at"][0]
    assert got == _recovery("repro", tmp_path / "j")
