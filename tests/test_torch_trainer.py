"""The port's TrainerWorker and training/serving CLIs, on the CPU.

Ports of ``tests/test_trainer_migration.py`` (checkpoint round trip,
replay determinism, migration through the cluster), the reference
benchmark's pre-copy trainer workload, a reference worker's state
continued in the port, and the ``launch.train`` / ``launch.serve`` CLIs
with ``--device cpu``.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.broker.broker import Message as JMessage
from repro.core.trainer_worker import TrainerWorker as JTrainerWorker
from repro.data import DataConfig as JDataConfig
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.broker.broker import Message
from repro_torch.checkpoint import Registry
from repro_torch.cluster import TimingConstants
from repro_torch.core import MigrationPolicy, run_migration_experiment
from repro_torch.core.trainer_worker import TrainerWorker
from repro_torch.data import DataConfig
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep
from repro_torch.tree import flatten, leaves

# see tests/test_torch_train.py: Adam turns last-bit gradient differences
# on near-zero entries into up to 2 % of one step's lr
STEP_TOL = dict(rtol=1e-4, atol=2e-5)
# benchmarks/delta_precopy.py:WAN_TIMINGS, the trainer workload's profile
WAN_TIMINGS = TimingConstants(
    checkpoint_s=1.0, image_build_s=2.0, delta_build_s=0.5,
    push_base_s=0.5, pull_base_s=0.5, restore_s=2.0,
    registry_bw_Bps=10e6)


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: torch's intra-op threads cost more than
    they save, and beside other test processes they oversubscribe the
    cores (the suite runs files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# TrainerWorker (tests/test_trainer_migration.py, on the port)
# ---------------------------------------------------------------------------

def _make_factory():
    cfg = tconfigs.get_smoke("paper_consumer")
    tcfg = tstep.TrainStepConfig(
        remat="none", lr_peak=1e-3, warmup_steps=2, total_steps=1000,
        opt=tadamw.AdamWConfig(weight_decay=0.01))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    return lambda: TrainerWorker(cfg, tcfg, dcfg, device="cpu")


def test_trainer_state_checkpoint_roundtrip(tmp_path):
    make = _make_factory()
    w = make()
    for i in range(5):
        w.process(Message(i, {"batch_id": i}, 0.0))
    reg = Registry(str(tmp_path))
    rep = reg.push_image({"state": w.state_tree()})
    w2 = make()
    trees, _ = reg.pull_image(rep.image_id)
    w2.load_state(trees["state"])
    assert w2.state_equal(w)
    assert all(torch.equal(a, b) for a, b in
               zip(leaves(w2.opt_state), leaves(w.opt_state)))
    # both continue identically
    w.process(Message(5, {"batch_id": 5}, 0.0))
    w2.process(Message(5, {"batch_id": 5}, 0.0))
    assert w2.state_equal(w)


def test_trainer_replay_determinism():
    """fold(0..n) == fold(0..k) -> checkpoint -> fold(k..n), bit for bit,
    Adam moments included."""
    make = _make_factory()
    a, b = make(), make()
    msgs = [Message(i, {"batch_id": i}, 0.0) for i in range(8)]
    for m in msgs:
        a.process(m)
    for m in msgs[:4]:
        b.process(m)
    snap = b.state_tree()
    b.process(msgs[4])  # the snapshot is a copy: training on is harmless
    c = make()
    c.load_state(snap)
    for m in msgs[4:]:
        c.process(m)
    assert c.state_equal(a), "replay from checkpoint diverged from full fold"
    assert all(torch.equal(x, y) for x, y in
               zip(leaves(c.opt_state), leaves(a.opt_state)))


def test_trainer_migration_through_cluster(tmp_path):
    make = _make_factory()
    r = run_migration_experiment(
        "ms2m_statefulset", 4.0, registry_root=str(tmp_path),
        worker_factory=make, seed=0, t_migrate=5.0, settle_time=2.0)
    assert r.verified
    assert r.report.replayed_messages > 0


def test_trainer_precopy_int8_migration_verifies(tmp_path):
    """The reference benchmark's trainer workload (benchmarks/
    delta_precopy.py): dense updates every round, int8 deltas, an exact
    flush, a bit-exact restore."""
    r = run_migration_experiment(
        "ms2m_precopy", 4.0, registry_root=str(tmp_path),
        worker_factory=_make_factory(), seed=7, t_migrate=5.0,
        timings=WAN_TIMINGS, chunk_bytes=64 * 1024,
        policy=MigrationPolicy(compression="int8", precopy_max_rounds=8,
                               precopy_converge_ratio=100.0))
    assert r.verified
    assert r.report.precopy_rounds > 1
    assert r.report.image_wire_bytes < r.report.image_raw_bytes


def test_reference_trainer_state_continues_in_port():
    jcfg = jconfigs.get_smoke("paper_consumer")
    jtcfg = jstep.TrainStepConfig(
        remat="none", lr_peak=1e-3, warmup_steps=2, total_steps=1000,
        opt=jadamw.AdamWConfig(weight_decay=0.01))
    jw = JTrainerWorker(jcfg, jtcfg, JDataConfig(
        vocab_size=jcfg.vocab_size, seq_len=16, global_batch=2))
    for i in range(3):
        jw.process(JMessage(i, {"batch_id": i}, 0.0))
    tw = _make_factory()()
    tw.load_state(jw.state_tree())
    assert tw.step == 3 and tw.last_msg_id == 2
    for i in range(3, 6):
        jw.process(JMessage(i, {"batch_id": i}, 0.0))
        tw.process(Message(i, {"batch_id": i}, 0.0))
        np.testing.assert_allclose(tw.last_loss, jw.last_loss, rtol=1e-5)
    for t, j in zip(leaves(tw.params), jax.tree.leaves(jw.params)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **STEP_TOL)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def _final_params(root):
    reg = Registry(str(root))
    best = max(reg.list_images(), key=lambda i: reg.image_meta(i)["step"])
    return reg.pull_image(best)[0]["params"]


@pytest.mark.parametrize("arch", [
    "paper_consumer", "recurrentgemma_2b", "granite_moe_1b_a400m"])
def test_train_cli_resume_equals_straight_run(arch, tmp_path, capsys):
    base = ["--smoke", "--arch", arch, "--device", "cpu", "--log-every", "1"]
    straight, split = tmp_path / "straight", tmp_path / "split"
    assert ttrain.main(base + ["--steps", "6", "--registry",
                               str(straight)]) == 0
    assert ttrain.main(base + ["--steps", "3", "--registry", str(split)]) == 0
    assert ttrain.main(base + ["--steps", "6", "--resume", "--registry",
                               str(split)]) == 0
    out = capsys.readouterr().out
    assert "[train] resumed from step 2 image" in out
    assert out.count("[train] done; final loss") == 3
    a, b = _final_params(straight), _final_params(split)
    for x, y in zip(flatten(a)[0], flatten(b)[0]):
        np.testing.assert_array_equal(x, y)


def test_serve_cli_smoke(capsys):
    assert tserve.main(["--smoke", "--device", "cpu", "--requests", "3",
                        "--decode-steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "[serve] prefill 32 tokens x 3 requests" in out
    assert "[serve] decoded 4 steps x 3 requests" in out


def test_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the card is there: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ttrain.main(["--smoke", "--steps", "1", "--registry", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tserve.main(["--smoke"])
