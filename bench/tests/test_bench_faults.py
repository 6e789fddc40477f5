"""The comparison that decides ``correct`` fails what it must: a run with
the timed path broken underneath, on the CPU at a small size (past the
look for a card), and the control (the reference in fp8 in the program's
place) read against the same limits.

Faults: a served token altered where it is produced; a decode step that
leaves its cache unchanged; a target restored from its image that skips
its replay; a train step that returns its state unchanged; a train step
that leaves half of the batch out, the mean taken over the rest.  One
card holds each cell, so no exchange between cards can be left out.
"""
from __future__ import annotations

import pytest
import torch

from smoke import SECONDS, run_answers_for_its_own_imports, smoke_files  # noqa: F401

from faults import FAULTS
from harness.cell import execute

SEED = 2 ** 31 + 99


def _run(workload, **kw):
    return execute(smoke_files(workload), SEED, SECONDS, False, "cpu", **kw)


def test_sound_runs_pass():
    for w in ("glm-longctx-cutoff", "granite-train-statefulset"):
        assert _run(w)["correct"], w


@pytest.mark.parametrize("fault,workload,number", [
    ("served_token_altered", "glm-longctx-cutoff", "served_logit_gap"),
    ("decode_cache_unchanged", "glm-longctx-cutoff", "served_logit_gap"),
    ("replay_skipped", "glm-longctx-cutoff", "migrations_state_differs"),
    ("train_state_unchanged", "granite-train-statefulset", "change_norm_gap"),
    ("half_batch", "granite-train-statefulset", "loss_gap"),
    ("half_batch", "granite-train-statefulset", "grad_error_min"),
])
def test_a_planted_fault_is_not_correct(fault, workload, number):
    with FAULTS[fault]():
        r = _run(workload)
    assert not r["correct"]
    assert r["checks"][number]["value"] > r["checks"][number]["limit"]
    if fault == "train_state_unchanged":
        assert r["checks"][number]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", ["glm-longctx-cutoff",
                                      "granite-train-statefulset"])
def test_the_control_fails_a_number(workload):
    r = _run(workload, control=True)
    assert r["correct"]
    assert any(v["value"] > v["limit"] for v in r["control"].values()), \
        r["control"]
    assert torch.get_default_dtype() == torch.float32
