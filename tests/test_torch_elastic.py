"""The port's elastic scale-out (``repro_torch.core.elastic``) against the
JAX package's: the same bucket router, and a scale-out under load whose
ownership, per-bucket digests, processed counts and virtual times are
identical in both packages (and every moved bucket exact against the
reference fold)."""
import importlib

import numpy as np
import pytest

from repro.core import elastic as jelastic
from repro_torch.core import elastic as telastic


@pytest.mark.parametrize("buckets", [1, 7, 64])
def test_bucket_router_identical(buckets):
    for key in list(range(200)) + [12345, 2 ** 31 - 1]:
        got = telastic.bucket_of(key, buckets)
        assert 0 <= got < buckets
        assert got == jelastic.bucket_of(key, buckets)


def _scale_out(pkg, root):
    """The reference test's scenario: 32 buckets on 2 instances under
    ~10 msg/s, a third instance scaled out onto node2 at t=20, drained to
    t=150.  -> what it observed."""
    Cluster = importlib.import_module(f"{pkg}.cluster.cluster").Cluster
    elastic = importlib.import_module(f"{pkg}.core.elastic")
    rng = np.random.default_rng(0)
    cluster = Cluster(str(root), num_nodes=3)
    sim = cluster.sim
    svc = elastic.PartitionedService(cluster, "orders", num_buckets=32,
                                     num_instances=2)
    sim.process(svc.boot())
    published = []

    def producer():
        while sim.now < 120.0:
            yield float(rng.exponential(0.1))
            key = int(rng.integers(0, 1000))
            token = int(rng.integers(0, 997))
            msg = svc.publish(key, token)
            published.append((msg.msg_id, key, token))

    sim.process(producer())
    sim.run(until=20.0)
    n_before = [w.n_processed for w in svc.workers]
    done = sim.process(svc.scale_out("node2"))
    sim.run(stop_when=done)
    t_done = sim.now
    sim.run(until=sim.now + 30.0)
    n_during = [w.n_processed for w in svc.workers]
    sim.run(until=150.0)
    ref = svc.reference_fold(published)
    digests = {b: svc.workers[svc.ownership[b]].digests.get(b)
               for b in range(32)}
    return {"n_before": n_before, "n_during": n_during, "t_done": t_done,
            "ownership": dict(svc.ownership),
            "digests": {b: None if d is None else int(d)
                        for b, d in digests.items()},
            "exact": all(d is not None and np.uint64(d) == ref[b]
                         for b, d in digests.items()),
            "published": len(published)}


def test_scale_out_identical(tmp_path):
    got = _scale_out("repro_torch", tmp_path / "t")
    assert got["exact"], "a bucket's state diverged from the reference fold"
    assert all(b > a for a, b in zip(got["n_before"], got["n_during"][:2]))
    owners = list(got["ownership"].values())
    assert sorted(set(owners)) == [0, 1, 2]
    assert owners.count(2) == pytest.approx(32 // 3, abs=2)
    assert got == _scale_out("repro", tmp_path / "j")
