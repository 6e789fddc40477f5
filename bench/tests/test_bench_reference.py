"""The plain reference held to the port at smoke sizes on the CPU: the
forward of both models (the MoE with capacity drops) and three AdamW
steps."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from smoke import smoke_files

from harness import program
from harness.checks import _reference_weights, train_gaps
from harness.traffic import TrainBatches
from harness.weights import draw_params, flat_leaves, layout
from reference import model as ref
from repro_torch.models import transformer as T

SEED = 2 ** 31 + 12345  # seeds beyond 32 signed bits are the driver's


def _cfg_run(workload, **run):
    files = smoke_files(workload)
    files["config"]["run"].update(run)
    return program.model_config(files["config"]), files["config"]["run"]


@pytest.mark.parametrize("workload,seq", [("glm-longctx-cutoff", 24),
                                          ("granite-train-statefulset", 48)])
def test_forward_matches_port(workload, seq):
    cfg, run = _cfg_run(workload)
    params = draw_params(run, SEED, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, run["vocab_size"], (3, seq)))
    want, _ = T.lm_forward(params, {"tokens": tokens}, cfg)
    top, layer = _reference_weights(run, SEED, "cpu", False)
    x, _ = ref.hidden(top, layer, tokens, run)
    got = ref.head(ref.head_table(top), x, run, ref.F32)
    assert got.shape == want.shape
    assert torch.allclose(got, want.float(), rtol=1e-4, atol=1e-4)


def test_moe_drops_are_the_ports():
    """At a capacity factor where experts overflow, the reference keeps the
    same picks as the port (the first entries in token order)."""
    cfg, run = _cfg_run("granite-train-statefulset", capacity_factor=0.5)
    params = draw_params(run, SEED, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, run["vocab_size"], (2, 64)))
    want, aux_p = T.lm_forward(params, {"tokens": tokens}, cfg)
    top, layer = _reference_weights(run, SEED, "cpu", False)
    x, aux_r = ref.hidden(top, layer, tokens, run)
    got = ref.head(ref.head_table(top), x, run, ref.F32)
    assert torch.allclose(got, want.float(), rtol=1e-4, atol=1e-4)
    assert abs(float(aux_r) - float(aux_p)) <= 1e-5 * abs(float(aux_p))
    # and the cut does drop: the full-capacity forward differs
    cfg_full = dataclasses.replace(cfg, capacity_factor=4.0)
    full, _ = T.lm_forward(params, {"tokens": tokens}, cfg_full)
    assert not torch.allclose(full, want, rtol=1e-3, atol=1e-3)


def test_three_adamw_steps_match_port():
    files = smoke_files("granite-train-statefulset")
    cfg = program.model_config(files["config"])
    run, traffic = files["config"]["run"], files["traffic"]
    batches = TrainBatches(traffic, run["vocab_size"], SEED)
    params = draw_params(run, SEED, "cpu")
    w = program.trainer(cfg, traffic, params, batches, "t", "cpu")
    losses = []
    for i in range(3):
        w.process(type("M", (), {"msg_id": i, "payload": {"batch_id": i}}))
        losses.append(w.last_loss)
    weights = _reference_weights(run, SEED, "cpu", True)
    got = ref.train_readings(
        weights, [{k: torch.as_tensor(v) for k, v in batches.batch(i).items()}
                  for i in range(3)], run, traffic["optimizer"])
    assert np.allclose(got["loss"], losses, rtol=1e-5)
    now = flat_leaves(w.params)
    for path in layout(run):
        assert torch.allclose(weights[path], now[path], rtol=1e-4, atol=1e-6), path


def test_train_gaps_read_a_frozen_state_as_one():
    """A step that leaves its state unchanged reads 1 on the change gap;
    a gradient that is the reference's reads 0 error."""
    g = {"a": torch.ones(3), "b": torch.full((2,), 2.0)}
    want = {"loss": [5.0], "grad_norm": {"a": 1.0, "b": 2.0}, "grad": g,
            "change_norm": {"a": 0.1, "b": 0.2}}
    frozen_state = dict(want, change_norm={"a": 0.0, "b": 0.0})
    limits = {"change_norm_gap": 1e-3, "grad_error": 1e-3}
    assert train_gaps(frozen_state, want, limits)["change_norm_gap"][0] == 1.0
    same = train_gaps(want, want, limits)
    assert same["change_norm_gap"][0] == 0.0 and same["grad_error"][0] == 0.0
    assert same["loss_gap"][1] is None          # not compared: no limit
    half = dict(want, grad={"a": torch.ones(3), "b": torch.zeros(2)})
    assert train_gaps(half, want, limits)["grad_error"][0] == 1.0
