"""Cells at a size the CPU runs in seconds, for the harness's tests: the
benchmark's own configuration and traffic files with every size cut down
and float32 compute (so the plain reference agrees to rounding).

A configuration's sizes come from its own files: its model's ``SMOKE``
updated by the file's ``smoke`` block (which nothing on the card reads),
or, for a file with neither, ``SMOKE_RUN``."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.cell import load_model  # noqa: E402
from harness.common import ROOT, cell_files  # noqa: E402

SMOKE_RUN = {
    "chatglm3_6b": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                        head_dim=16, d_ff=96, vocab_size=300, dtype="float32"),
    "granite_moe_1b_a400m": dict(num_layers=2, d_model=64, num_heads=4,
                                 num_kv_heads=2, head_dim=16, d_ff=32,
                                 vocab_size=300, num_experts=4,
                                 num_experts_per_tok=2, dtype="float32"),
}
SERVE_MAX_SEQ = 1024
SMOKE_TRAFFIC = {
    "serve": dict(num_slots=4, max_seq=SERVE_MAX_SEQ, warmup_steps=1,
                  initial={"sessions": 4, "prefill_rows": 2,
                           "prompt": {"dist": "uniform", "min": 3, "max": 12},
                           "output": {"dist": "lognormal", "median": 300,
                                      "sigma": 0.8, "min": 40,
                                      "max": SERVE_MAX_SEQ}},
                  migrations={"first_s": 0.4, "every_s": 1.0, "count": 2},
                  cutoff={"t_replay_max_s": 0.02, "replay_entries_per_s": 100.0,
                          "log_entries_per_s": 100.0},
                  check={"sample_requests": 4},
                  limits={"served_logit_gap": 1e-3, "min_tokens_judged": 10}),
    "train": dict(batch=2, seq=16, check_steps=3,
                  migrations={"first_s": 0.6, "every_s": 0.0, "count": 1},
                  limits={"loss_gap": 1e-4, "grad_norm_gap": 1e-3,
                          "grad_error_median": 1e-3, "grad_error_min": 1e-3,
                          "change_norm_gap": 1e-3}),
}
SECONDS = 2.5


def smoke_run(config: dict, bench: Path = BENCH) -> dict:
    own = {**getattr(load_model(config, bench), "SMOKE", {}),
           **config.get("smoke", {})}
    return own or SMOKE_RUN[config["name"]]


def smoke_files(workload: str, root: Path = ROOT) -> dict:
    files = copy.deepcopy(cell_files(workload, root))
    files["config"]["run"].update(smoke_run(files["config"], root / "bench"))
    files["traffic"].update(copy.deepcopy(SMOKE_TRAFFIC[files["traffic"]["kind"]]))
    return files


@pytest.fixture(autouse=True)
def run_answers_for_its_own_imports(monkeypatch):
    """Autouse in each test file that imports it (those that call
    ``execute``): ``execute`` refuses a run once JAX or the JAX package is
    loaded, and with the repository's own tests in the same pytest worker
    another file may have loaded them first, so a run answers only for
    the modules it loads itself.  test_bench_no_jax.py holds a fresh
    process to all of them."""
    from harness import cell
    from harness.common import forbidden_loaded

    before = set(sys.modules)

    def found(modules=()):
        return [m for m in forbidden_loaded(modules) if m not in before]

    monkeypatch.setattr(cell, "forbidden_loaded", found)
