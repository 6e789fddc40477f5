"""The port's spans and byte counters (``repro_torch.trace``), on the CPU.

  * off: ``span`` is the shared no-op, nothing is recorded, and the
    engine's tokens and the trainer's state are bit-equal to a run with
    tracing on;
  * on: the engine's and the trainer's spans nest (dispatch and sync in
    the step; forward, backward and the optimizer in the dispatch) on one
    thread; a checkpoint's and a restore's bytes are the state's;
  * a push and a pull through a temporary ``Registry`` record each leaf's
    fingerprint, copy, hash, put, get and assembly with the leaf's bytes,
    the pool's placement of each leaf of two or more chunks inside its
    assembly, the push's and the pull's whole with the image's; a push
    on a second thread keeps its own parent stack; many threads at once
    lose no span and no byte;
  * under a CPU ``torch.profiler`` profile each span is a range of the
    same name;
  * ``tools/trace_torch_bench.py``: its trace reduction with the port's
    mirrored ranges reads the harness's busy time and labels, with the
    port's innermost span appended; its readings on hand-worked spans;
    and a whole smoke cell of each kind on the CPU with spans on.
"""
import importlib.util
import os
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import trace
from repro_torch.broker.broker import Message
from repro_torch.checkpoint.registry import Registry
from repro_torch.core.trainer_worker import TrainerWorker
from repro_torch.data import DataConfig
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.serving import Request
from repro_torch.serving import ServingEngine
from repro_torch.train import step as steplib
from repro_torch.tree import leaves
from tools import trace_torch_bench as tool

REPO = Path(__file__).resolve().parents[1]
CHUNK = 4096


@pytest.fixture(autouse=True)
def _clean():
    """Tracing off and no spans kept before and after every test; one
    intra-op thread (the tensors are tiny)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.disable()
    trace.spans()
    yield
    trace.disable()
    trace.spans()
    torch.set_num_threads(n)


def _engine(name="engine"):
    cfg = tconfigs.get_smoke("paper_consumer")
    return ServingEngine(cfg, T.init_lm(cfg, seed=3, device="cpu"),
                         num_slots=2, max_seq=32, name=name)


def _serve(eng):
    """Two requests admitted and decoded to the end -> every token."""
    eng.submit(Request(1, [5, 6, 7], max_new_tokens=6))
    eng.submit(Request(2, [9, 4], max_new_tokens=4))
    while eng.active.any():
        eng.step()
    return {c.request_id: c.tokens for c in eng.completions}


def _trainer():
    cfg = tconfigs.get_smoke("paper_consumer")
    tcfg = steplib.TrainStepConfig(
        remat="none", lr_peak=1e-3, warmup_steps=2, total_steps=100,
        opt=adamw.AdamWConfig(weight_decay=0.01))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    return TrainerWorker(cfg, tcfg, dcfg, device="cpu")


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _state():
    return {"w": torch.arange(3000, dtype=torch.float32).reshape(30, 100),
            "h": torch.ones(700, dtype=torch.bfloat16),
            "ids": np.arange(1500, dtype=np.int64),
            "step": np.int64(7)}


# ------------------------------------------------------------------ off
def test_off_span_is_the_shared_noop_and_records_nothing():
    a, b = trace.span("repro_torch.x"), trace.span("repro_torch.y", 5)
    assert a is b is trace.NO_SPAN
    with a as sp:
        sp.add(10)
    _serve(_engine())
    w = _trainer()
    w.process(Message(0, {"batch_id": 0}, 0.0))
    assert trace.spans() == []
    assert trace.current() is None


def test_engine_tokens_equal_with_tracing_on():
    eng_off = _engine()
    off = _serve(eng_off)
    trace.enable()
    eng_on = _engine()
    on = _serve(eng_on)
    assert on == off and len(on) == 2
    assert all(torch.equal(a, b) for a, b in
               zip(leaves(eng_on.cache), leaves(eng_off.cache)))
    assert trace.spans()


def test_trainer_state_equal_with_tracing_on():
    off, on = _trainer(), _trainer()
    for i in range(2):
        off.process(Message(i, {"batch_id": i}, 0.0))
    trace.enable()
    for i in range(2):
        on.process(Message(i, {"batch_id": i}, 0.0))
    assert on.state_equal(off) and on.last_loss == off.last_loss
    assert all(torch.equal(a, b) for a, b in
               zip(leaves(on.opt_state), leaves(off.opt_state)))


# ------------------------------------------------------------------- on
def test_engine_spans_nest_in_the_step_on_one_thread():
    eng = _engine()
    trace.enable()
    _serve(eng)
    got = _by_name(trace.spans())
    steps = {s.id: s for s in got["repro_torch.engine.step"]}
    for child in ("repro_torch.engine.dispatch", "repro_torch.engine.sync"):
        assert len(got[child]) == len(steps) > 0
        for s in got[child]:
            p = steps[s.parent]
            assert s.thread == p.thread == threading.get_ident()
            assert p.t0 <= s.t0 <= s.t1 <= p.t1
    assert all(s.parent == 0 for s in steps.values())
    for d, y in zip(got["repro_torch.engine.dispatch"],
                    got["repro_torch.engine.sync"]):
        assert d.parent == y.parent and d.t1 <= y.t0


def test_engine_checkpoint_and_restore_carry_the_cache_bytes():
    eng = _engine()
    eng.submit(Request(1, [5, 6, 7], max_new_tokens=8))
    cache_bytes = sum(t.numel() * t.element_size() for t in leaves(eng.cache))
    trace.enable()
    tree = eng.state_tree()
    other = _engine("target")
    other.load_state(tree)
    got = _by_name(trace.spans())
    assert [s.nbytes for s in got["repro_torch.engine.state_tree"]] == [
        cache_bytes]
    assert [s.nbytes for s in got["repro_torch.engine.load_state"]] == [
        cache_bytes]
    assert other.state_equal(eng)


def test_trainer_spans_nest_and_state_bytes():
    w = _trainer()
    trace.enable()
    w.process(Message(0, {"batch_id": 0}, 0.0))
    got = _by_name(trace.spans())
    (step,) = got["repro_torch.trainer.step"]
    (dispatch,) = got["repro_torch.trainer.dispatch"]
    (sync,) = got["repro_torch.trainer.sync"]
    assert step.parent == 0
    assert dispatch.parent == sync.parent == step.id
    assert dispatch.t1 <= sync.t0
    for phase in ("forward", "backward", "optimizer"):
        (s,) = got[f"repro_torch.train.{phase}"]
        assert s.parent == dispatch.id and s.thread == step.thread
    f, b, o = (got[f"repro_torch.train.{p}"][0]
               for p in ("forward", "backward", "optimizer"))
    assert f.t1 <= b.t0 and b.t1 <= o.t0
    state_bytes = trace.tree_bytes((w.params, w.opt_state))
    tree = w.state_tree()
    w2 = _trainer()
    w2.load_state(tree)
    got = _by_name(trace.spans())
    assert got["repro_torch.trainer.state_tree"][0].nbytes == state_bytes
    assert got["repro_torch.trainer.load_state"][0].nbytes == state_bytes
    assert w2.state_equal(w)


def _push_pull(tmp_path, tree):
    reg = Registry(str(tmp_path), CHUNK)
    rep = reg.push_image({"state": tree})
    trees, _ = reg.pull_image(rep.image_id)
    return rep, trees


def test_push_and_pull_record_each_phase_with_the_leaf_bytes(tmp_path):
    tree = _state()
    sizes = [trace.tree_bytes(x) for x in leaves(tree)]
    trace.enable()
    rep, trees = _push_pull(tmp_path, tree)
    got = _by_name(trace.spans())
    (push,) = got["repro_torch.registry.push"]
    (pull,) = got["repro_torch.registry.pull"]
    assert push.nbytes == rep.total_bytes == sum(sizes)
    assert pull.nbytes == rep.total_bytes
    assert push.parent == pull.parent == 0
    for name in ("d2h", "hash", "put", "fingerprint"):
        ss = got[f"repro_torch.registry.{name}"]
        assert [s.nbytes for s in ss] == sizes, name
        assert all(s.parent == push.id for s in ss)
    assert sum(s.nbytes for s in got["repro_torch.registry.fingerprint"]) \
        == rep.fp_bytes
    for name in ("get", "assemble"):
        ss = got[f"repro_torch.registry.{name}"]
        assert [s.nbytes for s in ss] == sizes, name
        assert all(s.parent == pull.id for s in ss)
    parts = sum(s.t1 - s.t0 for n in ("fingerprint", "d2h", "hash", "put")
                for s in got[f"repro_torch.registry.{n}"])
    assert parts <= push.t1 - push.t0
    assert trace.counters()["bytes"]["repro_torch.registry.pull"] >= sum(sizes)
    for k, v in tree.items():
        got_v = trees["state"][k]
        want = (v.view(torch.int16).numpy() if isinstance(v, torch.Tensor)
                and v.dtype == torch.bfloat16 else np.asarray(v))
        got_v = (got_v.view(np.int16) if want.dtype == np.int16
                 else got_v)
        assert np.array_equal(np.asarray(got_v), want)


def test_pull_places_the_leaves_of_two_or_more_chunks_on_the_pool(tmp_path):
    """``registry.place`` holds a leaf's bytes inside that leaf's
    ``registry.assemble``, on the pull's thread, exactly for the leaves
    of two or more chunks; its counter grows by their bytes."""
    tree = dict(_state(), two=np.ones(CHUNK // 4 + 1, np.float32))
    sizes = [trace.tree_bytes(x) for x in leaves(tree)]
    multi = [n for n in sizes if n > CHUNK]
    assert 0 < len(multi) < len(sizes)
    before = trace.counters()["bytes"].get("repro_torch.registry.place", 0)
    trace.enable()
    _push_pull(tmp_path, tree)
    got = _by_name(trace.spans())
    (pull,) = got["repro_torch.registry.pull"]
    assembles = got["repro_torch.registry.assemble"]
    places = got["repro_torch.registry.place"]
    assert [s.nbytes for s in places] == multi
    assert [s.parent for s in places] == [a.id for a in assembles
                                          if a.nbytes > CHUNK]
    assert all(s.thread == pull.thread for s in places)
    after = trace.counters()["bytes"]["repro_torch.registry.place"]
    assert after - before == sum(multi)


def test_a_push_on_a_second_thread_keeps_its_own_parent_stack(tmp_path):
    trace.enable()
    reg = Registry(str(tmp_path), CHUNK)
    pushed = {}

    def push():
        pushed["rep"] = reg.push_image({"state": _state()})
        pushed["thread"] = threading.get_ident()

    with trace.span("repro_torch.test.outer") as outer:
        th = threading.Thread(target=push)
        th.start()
        with trace.span("repro_torch.test.inner"):
            th.join(timeout=60)
            assert trace.current() == "repro_torch.test.inner"
        assert trace.current() == "repro_torch.test.outer"
    assert not th.is_alive() and "rep" in pushed
    got = _by_name(trace.spans())
    (push_span,) = got["repro_torch.registry.push"]
    assert push_span.parent == 0 and push_span.thread == pushed["thread"]
    assert push_span.thread != threading.get_ident()
    for name in ("d2h", "hash", "put", "fingerprint"):
        for s in got[f"repro_torch.registry.{name}"]:
            assert s.parent == push_span.id and s.thread == push_span.thread
    (inner,) = got["repro_torch.test.inner"]
    assert inner.parent == outer.id


def test_many_threads_lose_no_span_and_no_byte():
    n_threads, n_spans = 3 * (os.cpu_count() or 2), 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace.enable()
    try:
        def work(k):
            for i in range(n_spans):
                with trace.span("repro_torch.test.outer", 1):
                    with trace.span("repro_torch.test.inner") as sp:
                        sp.add(k)

        before = trace.counters()["bytes"]
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    got = trace.spans()
    assert len(got) == 2 * n_threads * n_spans
    assert len({s.id for s in got}) == len(got)
    ids = {s.id: s for s in got}
    for s in got:
        if s.name == "repro_torch.test.inner":
            assert ids[s.parent].name == "repro_torch.test.outer"
            assert ids[s.parent].thread == s.thread
        else:
            assert s.parent == 0
    after = trace.counters()["bytes"]
    assert (after["repro_torch.test.outer"]
            - before.get("repro_torch.test.outer", 0)) == n_threads * n_spans
    assert (after["repro_torch.test.inner"]
            - before.get("repro_torch.test.inner", 0)) == \
        n_spans * sum(range(n_threads))


def test_counters_read_the_kernels_launch_counters():
    from repro_torch.kernels import codec, decode_attention, flash_attention

    c = trace.counters()
    assert c["launches"]["decode_attention"] == decode_attention.LAUNCHES
    assert c["launches"]["flash_attention.wgmma"] == \
        flash_attention.WGMMA_LAUNCHES
    assert c["launches"]["int8_fp_lanes"] == codec.LAUNCHES["int8_fp_lanes"]
    assert all(isinstance(v, int) for v in c["launches"].values())


def test_profiler_ranges_carry_the_span_names():
    from torch.profiler import ProfilerActivity, profile

    eng = _engine()
    eng.submit(Request(1, [5, 6], max_new_tokens=8))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step()
    assert not [e for e in prof.events() if e.name.startswith("repro_torch.")]
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step()
    names = {e.name for e in prof.events()}
    assert {"repro_torch.engine.step", "repro_torch.engine.dispatch",
            "repro_torch.engine.sync"} <= names
    assert len(trace.spans()) == 3


# ----------------------------------------------------------------- tool
def _ev(name, start, end, device=False, thread=1):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(
        start=start, end=end), device_type="DeviceType.CUDA" if device
        else "DeviceType.CPU", thread=thread)


def test_tool_reduction_leaves_mirrored_port_ranges_out():
    from harness.trace import reduce_events

    plain = [_ev("bench.trace_window", 0, 1000),
             _ev("bench.engine_step", 0, 600),
             _ev("bench.push", 500, 1000, thread=2),
             _ev("k1", 100, 300, True), _ev("k1", 200, 400, True),
             _ev("k2", 700, 800, True), _ev("k0", -50, 20, True)]
    port = [_ev("repro_torch.engine.step", 0, 600),
            _ev("repro_torch.engine.dispatch", 0, 450),
            _ev("repro_torch.engine.sync", 450, 600),
            _ev("repro_torch.registry.d2h", 650, 850, thread=2),
            # the profiler's mirrors of the port's ranges on the device
            _ev("repro_torch.engine.step", 100, 600, True),
            _ev("repro_torch.engine.dispatch", 100, 400, True),
            _ev("repro_torch.registry.d2h", 700, 800, True)]
    base = reduce_events(plain)
    got = tool.reduce_labelled(plain + port)
    assert got["busy_s"] == pytest.approx(base["busy_s"])
    assert got["window_s"] == pytest.approx(base["window_s"])
    assert got["device_ops"] == base["device_ops"]
    assert got["idle_share_mirrored"] < got["idle_share"]
    idle = dict(got["idle_gaps"])
    assert idle == pytest.approx({
        "bench.engine_step > repro_torch.engine.dispatch": 80e-6,
        "bench.engine_step | bench.push > repro_torch.engine.sync": 300e-6,
        "bench.push": 200e-6})
    # every label starts with the harness's own
    prefixes = {k.split(" > ")[0] for k in idle}
    assert prefixes == {k for k, _ in base["idle_gaps"]}
    assert sum(idle.values()) == pytest.approx(
        sum(v for _, v in base["idle_gaps"]))
    assert got["port_labelled_share"] == pytest.approx(100 * 380 / 580)
    assert got["idle_by_span"] == pytest.approx({
        "repro_torch.engine.dispatch": 80e-6,
        "repro_torch.engine.sync": 300e-6})


def _span(name, t0, t1, nbytes=0, sid=1, parent=0):
    return trace.Span(name, sid, parent, 1, t0, t1, nbytes)


def test_tool_span_readings_on_hand_worked_spans():
    from harness.record import Migration, Record, Step

    rec = Record("w", {}, {}, 10.0)
    rec.steps = [Step(1.0, 1.1, "r", "decode"), Step(2.0, 2.2, "r", "decode"),
                 Step(9.9, 10.5, "r", "decode")]     # ends after the window
    m = Migration("ms2m_cutoff", 3.0, t_push0=3.1, t_push1=5.0, t_ready=7.0)
    rec.migrations = [m]
    spans = [_span("repro_torch.engine.dispatch", 1.0, 1.06),
             _span("repro_torch.engine.sync", 1.06, 1.1),
             _span("repro_torch.engine.dispatch", 2.0, 2.04),
             _span("repro_torch.engine.sync", 2.04, 2.2),
             _span("repro_torch.engine.dispatch", 9.9, 10.4),
             _span("repro_torch.registry.d2h", 3.2, 3.7, 2_000_000_000),
             _span("repro_torch.registry.d2h", 3.8, 4.3, 2_000_000_000),
             _span("repro_torch.registry.hash", 4.3, 4.8, 1_000_000_000),
             _span("repro_torch.registry.pull", 5.0, 6.0, 4_000_000_000),
             _span("repro_torch.engine.load_state", 6.0, 6.5, 4_000_000_000),
             # a restore after the migration's end: not the migration's
             _span("repro_torch.engine.load_state", 8.0, 9.0, 1)]
    r = tool.span_readings(spans, rec)
    assert r["dispatch_ms"] == pytest.approx(50.0)
    assert r["sync_wait_ms"] == pytest.approx(100.0)
    assert r["push_d2h_gbps"] == pytest.approx(4.0)
    assert r["push_hash_gbps"] == pytest.approx(2.0)
    assert r["pull_gbps"] == pytest.approx(4.0)
    assert r["restore_gbps"] == pytest.approx(8.0)
    (ph,) = tool.migration_phases(spans, rec)
    assert ph["registry.d2h"][:2] == [pytest.approx(1.0), 4_000_000_000]
    assert ph["push_parts_s"] == pytest.approx(1.5)
    assert ph["push_wall_s"] == pytest.approx(1.9)
    assert tool.span_readings([], rec) == dict.fromkeys(r)


def _smoke():
    path = REPO / "bench" / "tests" / "smoke.py"
    spec = importlib.util.spec_from_file_location("bench_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("workload", ["glm-longctx-cutoff",
                                      "granite-train-statefulset"])
def test_tool_runs_a_smoke_cell_with_spans_on(workload):
    smoke = _smoke()
    out = tool.run(smoke.smoke_files(workload), 11, smoke.SECONDS,
                   spans_on=True, profile=False, sync_debug=False,
                   device="cpu")
    assert trace.span("repro_torch.x") is trace.NO_SPAN
    r = out["spans"]
    assert all(v is not None and v > 0 for v in r.values()), r
    step = out["bench"]["engine_step_ms" if "glm" in workload
                        else "train_step_ms"]
    assert r["dispatch_ms"] + r["sync_wait_ms"] <= step
    for m in out["migrations"]:
        if m["t_ready"] is None:
            continue
        assert m["push_parts_s"] <= m["push_wall_s"]
        assert m["registry.pull"][1] == m["registry.push"][1]
        load = m.get("engine.load_state") or m["trainer.load_state"]
        assert load[1] > 0
    assert out["counters"]["bytes"]["repro_torch.registry.push"] > 0
    off = tool.run(smoke.smoke_files(workload), 11, smoke.SECONDS,
                   spans_on=False, profile=False, sync_debug=False,
                   device="cpu")
    assert off["n_spans"] == 0
    assert all(v is None for v in off["spans"].values())
