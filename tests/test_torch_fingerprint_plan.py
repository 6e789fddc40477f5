"""The chunk-fingerprint kernel's grid (``fingerprint.fingerprint_plan``)
and a plain-torch model of how the kernel combines its partial lanes, on
the CPU.

The CUDA kernel runs only on a card (``tests/test_torch_gpu.py`` and
``chip_smoke.py``).  What decides which words each of its threads reads is
the plan, computed here in Python: every row of every chunk must be read
once, for each of its 16-byte pieces, by exactly one thread.  The model
sums each CTA's rows and pieces on its own and then the runs of a slice
(the cluster's combine), and must give ``fingerprint_lanes_ref``'s bits
and the JAX package's.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import fingerprint as jfp
from repro_torch.kernels import fingerprint as fp

SMS = 132


def reads(plan, R):
    """How many times the kernel reads each (row, 16-byte piece) of one
    chunk: thread t of CTA (run k, slice s) reads piece s * pieces +
    t % pieces of rows r0 + t // pieces + (256 / pieces) j below the run's
    end (csrc/fingerprint.cu)."""
    count = np.zeros((R, fp.ROW_PIECES), np.int64)
    per_round = fp.THREADS // plan.pieces
    for k in range(plan.runs):
        r0 = k * plan.rows_per_cta
        r1 = min(R, r0 + plan.rows_per_cta)
        for s in range(fp.ROW_PIECES // plan.pieces):
            for t in range(fp.THREADS):
                count[r0 + t // plan.pieces:r1:per_round,
                      s * plan.pieces + t % plan.pieces] += 1
    return count


def check_plan(C, R):
    plan = fp.fingerprint_plan(C, R)
    assert plan == fp.fingerprint_plan(C, R)  # pure
    assert fp.ROW_PIECES % plan.pieces == 0
    assert 1 <= plan.runs <= fp.MAX_RUNS
    # the runs cover the rows, none of them empty
    assert (plan.runs - 1) * plan.rows_per_cta < R <= (
        plan.runs * plan.rows_per_cta)
    assert (reads(plan, R) == 1).all()
    return plan


@settings(max_examples=40, deadline=None)
@given(C=st.integers(1, 64), R=st.integers(1, 20000))
def test_plan_reads_every_row_and_piece_once(C, R):
    check_plan(C, R)


@pytest.mark.parametrize("C,R", [(1, 8192), (1, 8), (3, 77), (50, 8192),
                                 (1, 20000), (2, 1)])
def test_plan_at_named_shapes(C, R):
    check_plan(C, R)


def test_plan_fills_the_card_at_one_chunk():
    """The fold's 4 MiB chunk: 16 slices of 32 bytes x 9 runs of 911
    rows, 144 CTAs (at least one on every SM); the small leaf one CTA;
    50 chunks 2 slices of 256 bytes x 16 runs each."""
    fold = fp.fingerprint_plan(1, 8192)
    assert fold == fp.FingerprintPlan(rows_per_cta=911, runs=9, pieces=2)
    assert (fp.ROW_PIECES // fold.pieces) * fold.runs >= SMS
    assert fp.fingerprint_plan(1, 8) == fp.FingerprintPlan(8, 1, 32)
    assert fp.fingerprint_plan(50, 8192) == fp.FingerprintPlan(512, 16, 16)


def model_lanes(words, plan):
    """The kernel's combine in plain torch: each CTA's partial lanes (its
    run of rows, its slice of pieces), then a slice's runs added in rank
    order, all mod 2^32."""
    C, R, _ = words.shape
    u = fp._as_u32_values(words)
    w = fp._mix32(fp._mul32(torch.arange(1, R + 1, dtype=torch.int64),
                            fp._GOLD)) | 1
    lanes = torch.zeros((C, fp.LANES), dtype=torch.int64)
    width = 4 * plan.pieces
    for s in range(fp.LANES // width):
        cols = slice(s * width, (s + 1) * width)
        total = torch.zeros((C, width), dtype=torch.int64)
        for k in range(plan.runs):
            rows = slice(k * plan.rows_per_cta, (k + 1) * plan.rows_per_cta)
            part = fp._mul32(u[:, rows, cols], w[rows, None]).sum(1)
            total = (total + part) & fp._MASK32
        lanes[:, cols] = total
    return fp._as_int32_bits(lanes)


@pytest.mark.parametrize("C,R", [(1, 8192), (3, 77), (2, 300), (1, 8)])
def test_model_of_partials_equals_plain_and_jax(C, R):
    rng = np.random.default_rng(C * 1000 + R)
    raw = rng.integers(0, 2 ** 32, (C, R, fp.LANES), dtype=np.uint64)
    words = torch.from_numpy(raw.astype(np.uint32).view(np.int32))
    want = fp.fingerprint_lanes_ref(words)
    jax_lanes = np.asarray(jfp.fingerprint_lanes_ref(raw.astype(np.uint32)))
    assert np.array_equal(want.numpy().view(np.uint32), jax_lanes)
    plans = {fp.fingerprint_plan(C, R), fp.FingerprintPlan(-(-R // 4), 4, 8),
             fp.FingerprintPlan(R, 1, 1)}
    for plan in plans:
        assert torch.equal(model_lanes(words, plan), want), plan


def test_kernel_wrapper_refuses_cpu_words():
    with pytest.raises(ValueError, match="CUDA"):
        fp.fingerprint_lanes(torch.zeros((1, 8, fp.LANES), dtype=torch.int32))


# -- chip_smoke.py times every leaf shape of the trainer paths' pushes ---------

def _chip_smoke():
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path,launches", [("train-rg", 520),
                                           ("train-granite", 37),
                                           ("train-whisper", 76)])
def test_chip_smoke_times_every_trainer_push_shape(path, launches):
    """``push_shapes`` counts one launch a leaf of params, m and v and one
    for the step count (the launches a push makes on the card), and
    ``chip_smoke.py`` times each of their shapes, each within the plan's
    reach."""
    cs = _chip_smoke()
    shapes = cs.push_shapes(cs.FP_PUSHES[path])
    assert sum(shapes.values()) == launches
    timed = {(C, R) for label, C, R in cs.FP_CASES if label in cs.FP_TIMED}
    assert set(shapes) <= timed
    for C, R in shapes:
        plan = fp.fingerprint_plan(C, R)
        assert (reads(plan, R) == 1).all()
