"""The harness on the CPU: cells found by name from added files, the
readers' arithmetic against hand-worked values, the trace reduction, and
no measurement path that carries on without a card."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from smoke import (BENCH, SECONDS, run_answers_for_its_own_imports,  # noqa: F401
                   smoke_files)

from harness import flops, program
from harness.cell import execute, load_model, reader
from harness.common import cell_files
from harness.record import Migration, Record, Step
from harness.trace import reduce_events

ROOT = BENCH.parent


def _checkout(tmp_path: Path) -> Path:
    """The files a benchmark checkout holds for the harness: BENCHMARK.json
    and ``bench/``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_a_cell_added_by_files_alone_is_found(tmp_path):
    root = _checkout(tmp_path)
    (root / "bench/configs/tiny_dense.json").write_text(json.dumps(
        {"name": "tiny_dense", "port_arch": "chatglm3_6b",
         "run": smoke_files("glm-longctx-cutoff")["config"]["run"]}))
    traffic = smoke_files("glm-longctx-cutoff")["traffic"]
    traffic["initial"]["sessions"] = 3
    (root / "bench/traffic/tiny_chat.json").write_text(json.dumps(traffic))
    (root / "bench/metrics/served_requests.py").write_text(
        "def read(rec):\n    return float(len(rec.served))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_dense", "source": "x",
                            "file": "bench/configs/tiny_dense.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "tiny-chat", "config": "tiny_dense",
                              "traffic": "tiny_chat", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "served_requests", "unit": "requests",
                              "better": "higher", "source": "host_clock",
                              "layer": "workers", "moves": "tokens_per_s",
                              "workloads": ["tiny-chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    files = cell_files("tiny-chat", root)
    assert files["config"]["name"] == "tiny_dense"
    assert files["traffic"]["initial"]["sessions"] == 3
    assert [m["name"] for m in files["per_layer"]] == ["served_requests"]
    assert "itl_p95_ms" not in [m["name"] for m in files["end_to_end"]]
    result = execute(files, 7, SECONDS, False, "cpu")
    assert result["correct"]
    rec = Record("tiny-chat", {}, {}, 1.0, served={1: [(0.1, 3)], 2: []})
    assert reader("served_requests", root / "bench")(rec) == 2.0


SHARED_LINE = "    y = y + shared(W, h, prec)  # the shared expert\n"


def _add_shared_expert_configuration(root: Path, fault: bool) -> None:
    """A configuration with a model of its own, added by files alone:
    granite's sizes with ``shared_expert`` (outside the default decoder),
    its model module, and a serving and a training cell over today's
    traffic.  With ``fault`` the module's reference leaves the shared
    expert out."""
    text = (BENCH / "tests/shared_expert_model.py").read_text()
    if fault:
        assert SHARED_LINE in text
        text = text.replace(SHARED_LINE, "")
    (root / "bench/models").mkdir()
    (root / "bench/models/tiny_moe_shared.py").write_text(text)
    run = dict(cell_files("granite-train-statefulset")["config"]["run"],
               shared_expert=True)
    # capacity for every pick: the port routes a served prompt by prefill
    # chunk and then a token a step, the reference the whole sequence
    (root / "bench/configs/tiny_moe_shared.json").write_text(json.dumps(
        {"name": "tiny_moe_shared", "port_arch": "granite_moe_1b_a400m",
         "model": "models/tiny_moe_shared.py", "run": run,
         "smoke": {"capacity_factor": 4.0}}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_moe_shared", "source": "x",
                            "file": "bench/configs/tiny_moe_shared.json",
                            "reduced": [], "why": "x"})
    for name, traffic in (("tiny-shared-chat", "longctx_cutoff"),
                          ("tiny-shared-train", "train_statefulset")):
        spec["workloads"].append({"name": name, "config": "tiny_moe_shared",
                                  "traffic": traffic, "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.mark.parametrize("fault", [False, True])
@pytest.mark.parametrize("workload,number", [
    ("tiny-shared-chat", "served_logit_gap"),
    ("tiny-shared-train", "loss_gap")])
def test_a_configuration_added_with_its_own_model(tmp_path, workload, number,
                                                  fault):
    """The harness draws, runs and judges a cell with the file's model: the
    port builds the shared expert the run block asks for, and a reference
    that leaves it out is not correct."""
    root = _checkout(tmp_path)
    _add_shared_expert_configuration(root, fault)
    files = smoke_files(workload, root)
    run = files["config"]["run"]
    assert run["shared_expert"] and run["capacity_factor"] == 4.0
    assert run["d_model"] == 64          # the model module's SMOKE
    model = load_model(files["config"], root / "bench")
    assert "groups/b0/moe/shared/w_up" in model.layout(run)
    assert program.model_config(files["config"]).shared_expert
    result = execute(files, 2 ** 31 + 7, SECONDS, False, "cpu")
    assert result["correct"] is not fault, result["checks"]
    v = result["checks"][number]
    assert (v["value"] > v["limit"]) is fault


def _served_record(stall_s: float, n: int = 100) -> Record:
    """Two requests, a token every 100 ms; with ``stall_s``, one stall of
    that length in the middle of both (a migration stops the replica)."""
    served = {}
    for rid in (1, 2):
        t, toks = 0.0, []
        for i in range(n):
            t += 0.1 + (stall_s if i == n // 2 else 0.0)
            toks.append((t, i))
        served[rid] = toks
    return Record("w", {}, {}, 30.0, served=served)


def test_itl_counts_the_stall_of_a_migration():
    itl = reader("itl_p95_ms")
    calm, stalled = itl(_served_record(0.0, 10)), itl(_served_record(2.0, 10))
    assert calm == pytest.approx(100.0)
    assert stalled > calm + 1000.0


def test_itl_tail_is_over_all_gaps():
    """The tail of every gap of every request: one stall of 2 s in 198
    gaps stays under the 95th percentile, twelve rise above it."""
    itl = reader("itl_p95_ms")
    assert itl(_served_record(2.0)) == pytest.approx(100.0)
    rec = _served_record(0.0)
    for rid in (1, 2):
        rec.served[rid] = [(t + 2.0 * sum(1 for s in range(5, 100, 16)
                                          if j >= s), k)
                           for j, (t, k) in enumerate(rec.served[rid])]
    assert itl(rec) > 1000.0


RUN = {"family": "dense", "num_layers": 2, "d_model": 8, "num_heads": 2,
       "num_kv_heads": 1, "head_dim": 4, "d_ff": 16, "vocab_size": 10}


def test_tokens_per_s_and_mfu_hand_worked():
    # serving: a 3-token history, 2 tokens served (from the steps at
    # positions 2 and 3), one more after the 10 s window
    rec = Record("w", RUN, {}, 10.0,
                 served={5: [(4.0, 7), (5.0, 8), (11.0, 9)]},
                 prompt_len={5: 3})
    assert reader("tokens_per_s")(rec) == pytest.approx(0.2)
    # weights a token multiplies: 2 layers x (attn 8*8*2 + 8*4*2 = 192,
    # MLP 3*8*16 = 384) + head 8*10 = 1232; attention: 2 layers * 4 * 2
    # heads * 4 dims = 64 flops a key
    assert flops.active_matmul_params(RUN) == 1232
    per_token = [2 * 1232 + 64 * (pos + 1) for pos in (2, 3)]
    assert reader("mfu")(rec) == pytest.approx(
        100 * sum(per_token) / (10.0 * 989e12))
    # training: 4 batches of 2 x 3 tokens in 2 s
    t = {"batch": 2, "seq": 3}
    rec = Record("w", RUN, t, 2.0, trained=[(0.1 * i, i) for i in range(4)],
                 tokens_per_batch=6)
    assert reader("tokens_per_s")(rec) == pytest.approx(12.0)
    batch = 6 * 1232 * 6 + 3 * 2 * 4 * 2 * 4 * (3 * 4 // 2) * 2
    assert flops.train_batch_flops(RUN, 2, 3) == batch
    assert reader("mfu")(rec) == pytest.approx(100 * 4 * batch / (2.0 * 989e12))


def test_migration_readers():
    a = Migration("ms2m_cutoff", 1.0, t_push0=1.0, t_push1=3.0,
                  push_bytes=4_000_000_000, t_last_source=2.0,
                  t_first_target=2.5, t_switch=2.4, replay_entries=10,
                  replay_s=0.5)
    b = Migration("ms2m_cutoff", 5.0, t_push0=5.0, t_push1=6.0,
                  push_bytes=2_000_000_000, t_last_source=6.0,
                  t_first_target=7.5, t_switch=7.4, replay_entries=30,
                  replay_s=1.5)
    late = Migration("ms2m_cutoff", 9.0, t_switch=11.0, t_last_source=9.5,
                     t_first_target=11.1)
    rec = Record("w", RUN, {}, 10.0, migrations=[a, b, late])
    assert reader("downtime_ms")(rec) == pytest.approx(1000.0)
    assert reader("migration_s")(rec) == pytest.approx(1.9)
    assert reader("push_gbps")(rec) == pytest.approx(2.0)
    assert reader("replay_msgs_per_s")(rec) == pytest.approx(20.0)


def _ev(name, start, end, device=False, thread=1):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(
        start=start, end=end), device_type="DeviceType.CUDA" if device
        else "DeviceType.CPU", thread=thread)


def test_trace_reduction_busy_and_idle_by_host_span():
    events = [_ev("bench.trace_window", 0, 1000),
              _ev("bench.engine_step", 0, 600),
              _ev("bench.push", 500, 1000, thread=2),
              _ev("k1", 100, 300, True), _ev("k1", 200, 400, True),
              _ev("k2", 700, 800, True), _ev("k0", -50, 20, True)]
    s = reduce_events(events)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx((20 + 300 + 100) * 1e-6)
    assert s["kernels"]["k1"] == [2, pytest.approx(400e-6)]
    idle = dict(s["idle_gaps"])
    assert idle["bench.engine_step"] == pytest.approx(80e-6)
    assert idle["bench.engine_step | bench.push"] == pytest.approx(300e-6)
    assert idle["bench.push"] == pytest.approx(200e-6)


def test_roofline_readers_are_shares_of_the_bound():
    run = dict(RUN, num_heads=32, num_kv_heads=2, head_dim=128)
    bound = flops.decode_attention_bound_s(run, 1000, 64, 2048)
    trace = {"kernels": {"void decode_cluster_kernel<bf16>": [10, 10 * 2 * bound]},
             "t_on": 0.0, "t_off": 1.0}
    rec = Record("w", run, {"num_slots": 64, "max_seq": 2048}, 1.0,
                 steps=[Step(0.1, 0.2, "r", "decode", 1000)], trace=trace)
    assert reader("decode_attention_roofline")(rec) == pytest.approx(50.0)
    rec.trace = {"kernels": {"other": [1, 1.0]}, "t_on": 0.0, "t_off": 1.0}
    assert reader("decode_attention_roofline")(rec) is None


def _run_py(cwd: Path, *args):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "glm-longctx-cutoff",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, capture_output=True, text=True, timeout=120)


def test_no_card_no_result():
    """Without a card the run fails and prints no result line (this
    sandbox's torch has no CUDA)."""
    import torch

    assert not torch.cuda.is_available()
    p = _run_py(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA card" in p.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    p = _run_py(_checkout(tmp_path))
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_program_on_a_missing_card_raises():
    """The measured path asks the port for the card; the port raises
    rather than running on the CPU."""
    from harness import serving

    files = smoke_files("glm-longctx-cutoff")
    import torch

    cell = serving.ServeCell(files["config"], files["traffic"], 1, 1.0, False,
                             "cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        cell.setup()
    assert not torch.cuda.is_available()


@pytest.mark.parametrize("second,lost", [([1, 2, 3], 0), ([1, 2, 4], 1)])
def test_a_second_completion_must_carry_the_same_tokens(second, lost):
    """A session the source finished and the target finishes again in its
    replay is delivered once; the second finish must say the same."""
    from harness.serving import ServeCell
    from repro_torch.serving.engine import Completion

    files = smoke_files("glm-longctx-cutoff")
    cell = ServeCell(files["config"], files["traffic"], 1, 1.0, False, "cpu")

    def replica(name, tokens):
        return SimpleNamespace(name=name, engine=SimpleNamespace(
            generated={}, request_of_slot={},
            completions=[Completion(7, tokens)]))

    cell.ledger.submitted[7] = -1.0
    cell.primary = replica("replica-0", [1, 2, 3])
    cell.collect(cell.primary, 0.5)
    cell.collect(replica("replica-1", second), 0.6)
    assert list(cell.ledger.delivered) == [7]
    assert cell.exactly_once() == lost
