"""Cells at a size the CPU runs in seconds, for the harness's tests: the
benchmark's own configuration and traffic files with every size cut down
and float32 compute (so the plain reference agrees to rounding)."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.common import cell_files  # noqa: E402

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


def smoke_files(workload: str) -> dict:
    files = copy.deepcopy(cell_files(workload))
    files["config"]["run"].update(SMOKE_RUN[files["config"]["name"]])
    files["traffic"].update(copy.deepcopy(SMOKE_TRAFFIC[files["traffic"]["kind"]]))
    return files
