"""The port's stateful consumer on the CPU: the MS2M premise (checkpoint
mid-stream -> registry -> restore -> replay is bit-exact with the
straight fold) and parity of its state with the JAX consumer."""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.consumer import StatefulConsumer as JConsumer
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.broker.broker import Message
from repro_torch.checkpoint import Registry
from repro_torch.convert import tree_from_jax
from repro_torch.core.consumer import StatefulConsumer, measure_replay_speedup
from repro_torch.tree import leaves

MAX_SEQ = 64
# float32 through 2 layers over 24 steps (XLA vs torch sum order)
TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def models():
    jcfg = jconfigs.get_smoke("paper_consumer")
    tcfg = tconfigs.get_smoke("paper_consumer")
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = tree_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _messages(n, seed=5):
    rng = np.random.default_rng(seed)
    return [Message(i, {"token": int(t)}, 0.0)
            for i, t in enumerate(rng.integers(0, 512, n))]


def test_checkpoint_restore_replay_is_bit_exact(models, tmp_path):
    _, _, cfg, params = models
    msgs = _messages(24)
    straight = StatefulConsumer(cfg, params, MAX_SEQ)
    straight.replay_sequential(msgs)

    source = StatefulConsumer(cfg, params, MAX_SEQ)
    source.replay_sequential(msgs[:10])
    snapshot = source.state_tree()
    source.replay_sequential(msgs[10:13])  # source keeps serving in place
    reg = Registry(str(tmp_path))
    image = reg.push_image({"state": snapshot})
    trees, _ = reg.pull_image(image.image_id)

    target = StatefulConsumer(cfg, params, MAX_SEQ)
    target.load_state(trees["state"])
    assert target.pos == 10 and target.last_msg_id == 9
    target.replay_sequential(msgs[10:])
    assert target.state_equal(straight, exact=True)
    for a, b in zip(leaves(target.cache), leaves(straight.cache)):
        assert torch.equal(a, b)


def test_replay_paths(models):
    _, _, cfg, params = models
    msgs = _messages(20, seed=6)
    seq = StatefulConsumer(cfg, params, MAX_SEQ)
    seq.replay_sequential(msgs)
    scan = StatefulConsumer(cfg, params, MAX_SEQ)
    assert scan.replay_scan(msgs) == 20 and scan.replay_scan([]) == 0
    assert scan.state_equal(seq, exact=True)
    chunked = StatefulConsumer(cfg, params, MAX_SEQ)
    assert chunked.replay_chunked(msgs, chunk=8) == 20
    assert chunked.state_equal(seq, exact=False)
    assert chunked.n_processed == seq.n_processed == 20
    assert measure_replay_speedup(cfg, params, n=8, max_seq=32) >= 1.0


def test_state_matches_jax_consumer(models):
    jcfg, jparams, cfg, params = models
    msgs = _messages(24, seed=8)
    jc = JConsumer(jcfg, jparams, MAX_SEQ)
    tc = StatefulConsumer(cfg, params, MAX_SEQ)
    for m in msgs:
        jc.process(m)
        tc.process(m)
    jtree, ttree = jc.state_tree(), tc.state_tree()
    assert ttree["scalars"] == jtree["scalars"]
    jl = jax.tree.leaves(jtree["cache"])
    tl = leaves(ttree["cache"])
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_consumer_device_follows_params(models):
    _, _, cfg, params = models
    c = StatefulConsumer(cfg, params, 16)
    assert c.device == torch.device("cpu")
    assert all(x.device.type == "cpu" for x in leaves(c.cache))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            StatefulConsumer(cfg, params, 16, device="cuda")
