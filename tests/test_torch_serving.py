"""Serving and rebalancing: the port against the JAX package, on the CPU.

  * hash worker: ``run_serving_experiment`` rows (p99, downtime,
    exactly-once, state verification) are identical, with and without
    delta pre-copy through the codecs;
  * engine: with the reference's weights (converted with
    ``repro_torch.convert``), the port's ``ServingEngine`` generates the
    same tokens as the JAX engine over a request stream, and its KV cache
    is allclose (float32, rtol = atol = 1e-5: the two frameworks sum in
    different orders); a checkpoint taken mid-generation and replayed
    gives a state ``torch.equal`` to the straight run;
  * rebalance: ``run_rebalance_scenario`` rows are identical, with and
    without the predictive controller;
  * CLI: ``repro_torch.launch.migrate --device cpu`` exits 0 on the new
    paths.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.broker.broker import Message as JMessage
from repro.cluster import Fault as JFault
from repro.cluster.controller import RebalanceConfig as JRebalanceConfig
from repro.cluster.controller import run_rebalance_scenario as jax_rebalance
from repro.core import MigrationPolicy as JPolicy
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving.handoff import ServingWorker as JWorker
from repro.serving.handoff import run_serving_experiment as jax_serving
from repro_torch import configs as tconfigs
from repro_torch.broker.broker import Message as TMessage
from repro_torch.cluster import Fault as TFault
from repro_torch.cluster import RebalanceConfig as TRebalanceConfig
from repro_torch.cluster import run_rebalance_scenario as torch_rebalance
from repro_torch.convert import tree_from_jax
from repro_torch.core import MigrationPolicy as TPolicy
from repro_torch.serving import Request as TRequest
from repro_torch.serving import ServingEngine as TEngine
from repro_torch.serving import slot_aligned_chunk_bytes
from repro_torch.serving.handoff import ServingWorker as TWorker
from repro_torch.serving.handoff import run_serving_experiment as torch_serving
from repro_torch.tree import leaves

REPO = Path(__file__).resolve().parents[1]
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------- hash worker

@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("strategy,codec", [
    ("serving_handoff", None), ("serving_handoff", "int8"),
    ("serving_handoff", "xor_rle"), ("ms2m_cutoff", "auto"),
    ("ms2m_individual", None)])
def test_hash_serving_rows_identical(tmp_path, strategy, codec, seed):
    def policy(cls):
        return (cls(precopy=True, compression=codec) if codec else None)

    kw = dict(seed=seed, worker="hash")
    want = jax_serving(strategy, 8.0, registry_root=str(tmp_path / "j"),
                       policy=policy(JPolicy), **kw)
    got = torch_serving(strategy, 8.0, registry_root=str(tmp_path / "t"),
                        policy=policy(TPolicy), device="cpu", **kw)
    assert got.row() == want.row()
    assert got.exactly_once and got.state_verified is True
    assert got.latency() == want.latency()


# ---------------------------------------------------------------- engine

@pytest.fixture(scope="module")
def engines():
    jcfg = jconfigs.get_smoke("paper_consumer")
    tcfg = tconfigs.get_smoke("paper_consumer")
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = tree_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _payloads(n, seed):
    rng = np.random.default_rng(seed)
    return [{"request_id": i,
             "prompt": [int(t) for t in rng.integers(1, 50, 1 + i % 3)],
             "max_new_tokens": int(rng.integers(2, 8))} for i in range(n)]


def test_engine_tokens_identical_to_jax(engines):
    jcfg, jparams, tcfg, tparams = engines
    jeng = JEngine(jcfg, jparams, num_slots=2, max_seq=64)
    teng = TEngine(tcfg, tparams, num_slots=2, max_seq=64)
    for i in range(5):  # more requests than slots: admission queueing
        prompt = [3 + i, 9, 2 * i + 1][: 1 + i % 3]
        jeng.submit(JRequest(i, prompt, max_new_tokens=5))
        teng.submit(TRequest(i, prompt, max_new_tokens=5))
    for _ in range(80):
        jeng.step()
        teng.step()
    want = sorted((c.request_id, c.tokens) for c in jeng.completions)
    got = sorted((c.request_id, c.tokens) for c in teng.completions)
    assert len(got) == 5 and got == want
    for a, b in zip(leaves(teng.cache), jax.tree.leaves(jeng.cache)):
        torch.testing.assert_close(a, torch.from_numpy(np.array(b)),
                                   **CACHE_TOL)


def test_engine_worker_stream_matches_jax(engines):
    """The MS2M worker API (one message = one admission + its decode
    rounds) over a seeded stream: same completions, allclose cache."""
    jcfg, jparams, tcfg, tparams = engines
    jw = JWorker(JEngine(jcfg, jparams, num_slots=2, max_seq=64),
                 decode_rounds=2)
    tw = TWorker(TEngine(tcfg, tparams, num_slots=2, max_seq=64),
                 decode_rounds=2)
    for i, p in enumerate(_payloads(8, seed=5)):
        jw.process(JMessage(i, p, 0.0))
        tw.process(TMessage(i, p, 0.0))
    assert tw.slot_table() == jw.slot_table()
    jw.flush()
    tw.flush()
    want = sorted((c.request_id, c.tokens) for c in jw.engine.completions)
    got = sorted((c.request_id, c.tokens) for c in tw.engine.completions)
    assert got == want
    for a, b in zip(leaves(tw.engine.cache), jax.tree.leaves(jw.engine.cache)):
        torch.testing.assert_close(a, torch.from_numpy(np.array(b)),
                                   **CACHE_TOL)


def test_engine_mid_generation_checkpoint_replay_is_exact(engines):
    _, _, tcfg, tparams = engines

    def make(name):
        return TWorker(TEngine(tcfg, tparams, num_slots=2, max_seq=64,
                               name=name), decode_rounds=2)

    payloads = _payloads(8, seed=11)
    ref = make("ref")
    for i, p in enumerate(payloads):
        ref.process(TMessage(i, p, 0.0))
    ref.flush()
    src = make("src")
    for i, p in enumerate(payloads[:4]):
        src.process(TMessage(i, p, 0.0))
    assert any(s["request_id"] >= 0 for s in src.slot_table())
    tree = src.state_tree()
    # the snapshot is a copy: the source decoding on does not reach it
    before = [t.clone() for t in leaves(tree["cache"])]
    src.engine.step(3)
    assert all(torch.equal(a, b)
               for a, b in zip(before, leaves(tree["cache"])))
    np_tree = jax.tree.map(
        lambda x: x.numpy() if isinstance(x, torch.Tensor) else x, tree)
    dst = make("dst")
    dst.load_state(np_tree)
    for i, p in enumerate(payloads[4:], start=4):
        dst.process(TMessage(i, p, 0.0))
    dst.flush()
    assert dst.state_equal(ref)
    for a, b in zip(leaves(dst.engine.cache), leaves(ref.engine.cache)):
        assert torch.equal(a, b)


def test_slot_aligned_chunk_bytes_matches_jax(engines):
    from repro.serving.handoff import slot_aligned_chunk_bytes as jchunk

    jcfg, jparams, tcfg, tparams = engines
    got = slot_aligned_chunk_bytes(
        TWorker(TEngine(tcfg, tparams, num_slots=4, max_seq=32)))
    want = jchunk(JWorker(JEngine(jcfg, jparams, num_slots=4, max_seq=32)))
    assert got == want > 0


# ------------------------------------------------------------- rebalance

def _flap(cls):
    return [cls("node_flap", at=20.0, node="node1", duration=8.0),
            cls("node_flap", at=70.0, node="node1", duration=25.0)]


@pytest.mark.parametrize("controller", [False, True])
@pytest.mark.parametrize("seed", [0, 2])
def test_rebalance_rows_identical(tmp_path, controller, seed):
    kw = dict(n_pods=4, num_nodes=3, message_rate=5.0, t_end=100.0,
              sample_dt=1.0, seed=seed)
    want = jax_rebalance(registry_root=str(tmp_path / "j"),
                         faults=_flap(JFault),
                         controller=JRebalanceConfig() if controller else None,
                         **kw)
    got = torch_rebalance(registry_root=str(tmp_path / "t"),
                          faults=_flap(TFault),
                          controller=TRebalanceConfig() if controller else None,
                          **kw)
    assert got.row() == want.row()
    assert got.events == want.events
    assert got.all_verified
    assert (got.n_moves > 0) == controller


# ------------------------------------------------------------------- CLI

def _cli(tmp_path, *args, timeout=600):
    # one intra-op thread: the full-width model runs beside the other test
    # workers, and oversubscribed torch threads slow both by far more
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.migrate", "--device", "cpu",
         "--registry", str(tmp_path / "reg"), *args],
        env=env, capture_output=True, text=True, timeout=timeout, cwd=REPO)


@pytest.mark.parametrize("args,expect", [
    (["--precopy", "--compression", "int8"], "verified=True"),
    (["--workload", "serving", "--hash-consumer", "--rate", "8",
      "--precopy", "--compression", "int8"],
     "exactly_once=True state_verified=True"),
    (["--workload", "serving", "--rate", "1", "--precopy", "--compression",
      "int8"], "exactly_once=True state_verified=True"),
    (["--workload", "rebalance", "--controller", "--fault",
      "node_flap@20,node=node1,duration=8", "--fault",
      "node_flap@70,node=node1,duration=25", "--n-pods", "4",
      "--num-nodes", "3", "--rate", "5", "--t-end", "100"],
     "all_verified=True"),
], ids=["fold-precopy-int8", "serving-hash", "serving-engine", "rebalance"])
def test_cli_new_paths_exit_zero(tmp_path, args, expect):
    out = _cli(tmp_path, *args)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert expect in out.stdout
