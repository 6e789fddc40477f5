"""The recurrence kernels' host-side plans, and plain-torch models of the
redesigned kernels' arithmetic, on the CPU.

The CUDA kernels themselves run only on a card (``tests/test_torch_gpu.py``
and ``chip_smoke.py``); what decides how they run is Python and is tested
here:

* ``rglru.scan_plan``: the chunks every block's producer warps compute
  and its walker warp walks, and which lane computes which step; a model
  of the kernel's arithmetic (gates by chunk, the state carried through
  the chunks in order) against ``ref.naive_rglru`` and the JAX package's
  ``naive_rglru``; and the finding that chose that design: with a_t near
  1, a chunk-parallel chain (h_in(k+1) = A_k * h_in(k) + l_k, then each
  chunk re-walked) and even the exact scan lie farther from the float32
  plain version than ``RGLRU_TOL``, so only the plain version's own
  rounding sequence meets it;
* ``slstm.slstm_plan``: the cluster, the columns of each CTA and the batch
  groups, the shared memory a CTA needs, and the L2 route where it does
  not fit; and a model of the cluster route (r split by column over the
  CTAs, h gathered from every CTA each step, the cell update rounded as
  the kernel rounds it) against ``ref.naive_slstm``.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels import rglru as rg
from repro_torch.kernels import slstm as sl

RGLRU_TOL = dict(rtol=1e-5, atol=1e-6)   # chip_smoke.py: float32 state
SLSTM_TOL = dict(rtol=1e-5, atol=1e-5)   # chip_smoke.py: float32
CHANNELS = 16  # channels a block walks (csrc/rglru.cu: kChannels)

# -- the RG-LRU plan ----------------------------------------------------------

# chip_smoke.py's RG-LRU cases (B, S, W), with this PR's: a slow decay and
# chunk boundaries at the long prompt's chunk of 56
RGLRU_SHAPES = [(8, 32, 2560), (2, 2304, 2560), (1, 64, 128), (2, 128, 256),
                (1, 96, 512), (3, 1, 2560), (2, 33, 70),
                (2, 56 * 40 + 1, 2560), (2, 56 * 40 - 1, 2560), (1, 56, 16),
                (4, 15, 17)]


def producer_steps(plan: rg.ScanPlan, warp: int, lane: int) -> list:
    """The steps of a chunk that producer ``warp`` (1..PRODUCERS), lane
    ``lane`` computes, as csrc/rglru.cu computes them (s0 + u * 2)."""
    u_steps = plan.chunk // (2 * rg.PRODUCERS)
    s0 = (warp - 1) * u_steps * 2 + lane // CHANNELS
    return [s0 + u * 2 for u in range(u_steps)]


@pytest.mark.parametrize("B,S,W", RGLRU_SHAPES)
def test_scan_plan_covers_every_step_and_channel_once(B, S, W):
    plan = rg.scan_plan(B, S, W)
    assert plan == rg.scan_plan(B, S, W)  # pure
    assert plan.chunk // (2 * rg.PRODUCERS) in rg.LANE_STEPS
    assert plan.chunk == 2 * rg.PRODUCERS * (plan.chunk // (2 * rg.PRODUCERS))
    # the walker's chunks, in order, cover [0, S) once, none empty
    bounds = rg.chunk_bounds(plan, S)
    assert [t for t0, t1 in bounds for t in range(t0, t1)] == list(range(S))
    assert all(t1 > t0 for t0, t1 in bounds)
    # a chunk's steps: each computed by exactly one (producer warp, lane
    # row) for every channel of the block
    for ch in range(CHANNELS):
        steps = sorted(s for warp in range(1, rg.PRODUCERS + 1)
                       for lane in (ch, ch + CHANNELS)
                       for s in producer_steps(plan, warp, lane))
        assert steps == list(range(plan.chunk))
    # blocks of CHANNELS channels over every batch row cover (b, w) once
    blocks = [(b, w0) for b in range(B) for w0 in range(0, W, CHANNELS)]
    cover = sorted((b, w) for b, w0 in blocks
                   for w in range(w0, min(W, w0 + CHANNELS)))
    assert cover == [(b, w) for b in range(B) for w in range(W)]


def test_scan_plan_at_the_paths_shapes():
    """The 2304-token prompt: 4 steps a producer lane, 42 chunks of 56 (the
    last 8); launch.serve's 32-token prefill and a decode-length call:
    chunks of 14, one step a lane."""
    assert rg.scan_plan(2, 2304, 2560) == rg.ScanPlan(56, 42)
    assert rg.chunk_bounds(rg.ScanPlan(56, 42), 2304)[-1] == (2296, 2304)
    assert rg.scan_plan(8, 32, 2560) == rg.ScanPlan(14, 3)
    assert rg.scan_plan(3, 1, 2560) == rg.ScanPlan(14, 1)
    assert rg.scan_plan(1, rg.LONG - 1, 16).chunk == 14
    assert rg.scan_plan(1, rg.LONG, 16).chunk == 56


# -- a model of the RG-LRU kernel's arithmetic --------------------------------

def _rglru_inputs(B, S, W, *, seed=0, a_mean=0.0, a_scale=1.0, h0=None,
                  dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x, ga, gx = (rng.standard_normal((B, S, W)).astype(np.float32)
                 for _ in range(3))
    a = (a_mean + a_scale * rng.standard_normal(W)).astype(np.float32)
    h = (None if h0 is None
         else (h0 * rng.standard_normal((B, W))).astype(np.float32))
    xs = [torch.from_numpy(t).to(dtype) for t in (x, ga, gx)]
    return xs[0], torch.from_numpy(a), xs[1], xs[2], (
        None if h is None else torch.from_numpy(h))


def walker_model(x, a_param, gate_a, gate_x, h0, plan, c=8.0):
    """csrc/rglru.cu in plain torch: the gates (elementwise; the producers
    run one scalar code for every element, whichever chunk holds it, so
    they are computed here once: torch's CPU kernels round a slice's
    vector body and tail apart), and the walker carrying h through the
    chunks in order, a product and a sum a step."""
    B, S, W = x.shape
    a_t, g = ref._rglru_gates(x, a_param, gate_a, gate_x, c)
    h = torch.zeros((B, W)) if h0 is None else h0.float()
    hs = torch.empty((B, S, W))
    for t0, t1 in rg.chunk_bounds(plan, S):
        for t in range(t0, t1):
            h = a_t[:, t] * h + g[:, t]
            hs[:, t] = h
    return hs.to(x.dtype), h


def chained_model(x, a_param, gate_a, gate_x, h0, chunk, c=8.0,
                  dtype=torch.float32):
    """The design not taken: each chunk's decay product A and end state l
    from 0, the chunks' incoming states chained h_in(k+1) = A_k * h_in(k)
    + l_k in ``dtype``, then each chunk re-walked in float32 from h_in."""
    B, S, W = x.shape
    a_t, g = ref._rglru_gates(x, a_param, gate_a, gate_x, c)
    h = torch.zeros((B, W), dtype=dtype) if h0 is None else h0.to(dtype)
    hs = torch.empty((B, S, W))
    for t0 in range(0, S, chunk):
        t1 = min(S, t0 + chunk)
        start = h.float()
        A = torch.ones((B, W), dtype=dtype)
        l = torch.zeros((B, W), dtype=dtype)
        for t in range(t0, t1):
            A, l = A * a_t[:, t].to(dtype), a_t[:, t].to(dtype) * l + g[
                :, t].to(dtype)
            start = a_t[:, t] * start + g[:, t]
            hs[:, t] = start
        h = A * h + l
    return hs, h


def _over_tolerance(got, want) -> float:
    """max |got - want| over RGLRU_TOL's allowance at ``want``."""
    got, want = got.double(), want.double()
    allow = RGLRU_TOL["atol"] + RGLRU_TOL["rtol"] * want.abs()
    return ((got - want).abs() / allow).max().item()


# (B, S, W of the model, W of the plan, a_param mean and scale, h0 scale):
# chip_smoke.py's cases at reduced width, with the slow-decay, h0-large
# and chunk-boundary cases
MODEL_CASES = [
    (8, 32, 48, 2560, 0.0, 1.0, 0.0),        # rg-serve
    (2, 2304, 24, 2560, 0.0, 1.0, 0.0),      # rg-long
    (2, 128, 40, 256, 0.0, 1.0, 1.0),        # h0
    (3, 1, 40, 2560, 0.0, 1.0, 1.0),         # one-step
    (2, 33, 70, 70, 0.0, 1.0, 1.0),          # ragged-width
    (2, 2304, 24, 2560, 6.0, 0.5, 1.0),      # slow-decay
    (2, 2304, 24, 2560, 0.0, 1.0, 100.0),    # h0-large
    (2, 2304, 24, 2560, 6.0, 0.5, 100.0),    # both
    (2, 56 * 40 + 1, 24, 2560, 6.0, 0.5, 1.0),  # chunk-boundary + 1
    (2, 56 * 40 - 1, 24, 2560, 6.0, 0.5, 1.0),  # chunk-boundary - 1
]


@pytest.mark.parametrize("B,S,W,W_plan,a_mean,a_scale,h0", MODEL_CASES)
def test_walker_model_gives_the_plain_versions_bits(B, S, W, W_plan, a_mean,
                                                    a_scale, h0):
    """The kernel's order of work changes no rounding: the walker model is
    the plain version bit for bit, so within RGLRU_TOL at every case,
    slow decay and a large h0 included."""
    x, a, ga, gx, h = _rglru_inputs(B, S, W, a_mean=a_mean, a_scale=a_scale,
                                    h0=h0 or None)
    plan = rg.scan_plan(B, S, W_plan)
    got = walker_model(x, a, ga, gx, h, plan)
    want = ref.naive_rglru(x, a, ga, gx, h)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], **RGLRU_TOL)


@pytest.mark.parametrize("B,S,W,h0", [(8, 32, 48, True), (2, 300, 40, False),
                                      (2, 33, 70, True)])
def test_walker_model_matches_jax_naive(B, S, W, h0):
    x, a, ga, gx, h = _rglru_inputs(B, S, W, seed=1, h0=1.0 if h0 else None)
    got = walker_model(x, a, ga, gx, h, rg.scan_plan(B, S, 2560))
    want = jref.naive_rglru(*(None if t is None else t.numpy()
                              for t in (x, a, ga, gx)),
                            None if h is None else h.numpy())
    torch.testing.assert_close(got[0], torch.from_numpy(np.asarray(want[0])),
                               **RGLRU_TOL)
    torch.testing.assert_close(got[1], torch.from_numpy(np.asarray(want[1])),
                               **RGLRU_TOL)


def test_slow_decay_needs_the_plain_versions_rounding():
    """With a_t = 0.95..1.0 and a large h0, the float32 plain version
    lies more than RGLRU_TOL from the exact scan (float64 on the same
    a_t and gated), and so does the chunk-parallel chain, in float32 or
    float64: only a walk with the plain version's roundings stays within
    it (test above)."""
    x, a, ga, gx, h = _rglru_inputs(2, 2304, 64, a_mean=6.0, a_scale=0.5,
                                    h0=100.0)
    want, _ = ref.naive_rglru(x, a, ga, gx, h)
    a_t, g = ref._rglru_gates(x, a, ga, gx, 8.0)
    assert 0.95 < a_t.min() and a_t.max() < 1.0
    hd, exact = h.double(), []
    for t in range(x.shape[1]):
        hd = a_t[:, t].double() * hd + g[:, t].double()
        exact.append(hd)
    assert _over_tolerance(torch.stack(exact, 1), want) > 1.2
    for dtype in (torch.float32, torch.float64):
        got, _ = chained_model(x, a, ga, gx, h, 56, dtype=dtype)
        assert _over_tolerance(got, want) > 1.2


# -- the sLSTM plan -----------------------------------------------------------

# (B, H, hb): the train shape, chip_smoke.py's and tests/test_kernels.py's,
# batch groups that do not divide, one head, the largest hb the cluster
# route takes and the L2 route's
SLSTM_SHAPES = [(8, 4, 256), (1, 2, 16), (2, 4, 32), (3, 3, 40), (3, 4, 256),
                (5, 4, 256), (1, 4, 256), (8, 1, 256), (2, 2, 512),
                (1, 1, 320), (16, 4, 256), (64, 4, 256), (7, 3, 100),
                (2, 2, 384), (1, 1, 448), (1, 1, 480)]


@pytest.mark.parametrize("B,H,hb", SLSTM_SHAPES)
def test_slstm_plan_covers_every_row_and_column_once(B, H, hb):
    plan = sl.slstm_plan(B, H, hb)
    assert plan == sl.slstm_plan(B, H, hb)  # pure
    groups = sl.plan_groups(plan, B)
    assert [b for b0, b1 in groups for b in range(b0, b1)] == list(range(B))
    assert all(b1 > b0 for b0, b1 in groups)
    cols = sl.plan_columns(plan, hb)
    assert [j for j0, j1 in cols for j in range(j0, j1)] == list(range(hb))
    if plan.route == "l2":
        assert plan == sl.SLSTMPlan("l2", 0, hb, 1)
        assert hb <= sl.MAX_HB
        return
    assert all(j1 > j0 for j0, j1 in cols)  # no CTA without columns
    assert 1 <= plan.cluster <= sl.MAX_CLUSTER
    assert 1 <= plan.rows <= sl.MAX_ROWS
    assert 2 * plan.cols <= 128  # the kernel's threads: 2 a column
    # a CTA's r columns and double-buffered h fit its shared memory
    assert sl.cluster_smem(hb, plan.cols, plan.rows) <= sl.MAX_SMEM
    # the fewest rows whose clusters fit one wave of the CTA slots that
    # the CTA's shared memory leaves (CLUSTER_FILL of them)
    def fits(rows):
        per_sm = sl.MAX_SMEM // sl.cluster_smem(hb, plan.cols, rows)
        return (-(-B // rows) * H * plan.cluster
                <= sl.CLUSTER_FILL * sl.SMS * per_sm)
    assert fits(plan.rows) or plan.rows == sl.MAX_ROWS
    assert plan.rows == 1 or not fits(plan.rows // 2)


def test_slstm_plan_at_the_train_shape():
    """xlstm_350m's train shape: clusters of 16 CTAs of 16 columns (66 KB
    of r each), two batch rows a cluster: 4 heads x 4 groups x 16 = 256
    CTAs of one warp, three an SM by shared memory, one wave."""
    plan = sl.slstm_plan(8, 4, 256)
    assert plan == sl.SLSTMPlan("cluster", 16, 16, 2)
    assert sl.cluster_smem(256, 16, 2) == 4 * (4 + 2 * 16 * 516 + 2 * 256 * 2)
    assert sl.MAX_SMEM // sl.cluster_smem(256, 16, 2) == 3


@pytest.mark.parametrize("B,H,hb", [(1, 1, 512), (8, 4, 512), (2, 2, 480),
                                    (1, 1, 496)])
def test_slstm_plan_takes_the_l2_route_where_r_does_not_fit(B, H, hb):
    plan = sl.slstm_plan(B, H, hb)
    assert plan.route == "l2"
    cluster = min(sl.MAX_CLUSTER, -(-hb // sl.CLUSTER_COLS))
    assert sl.cluster_smem(hb, -(-hb // cluster), 1) > sl.MAX_SMEM


# -- a model of the sLSTM cluster route's arithmetic --------------------------

def cluster_model(xs, rs, plan):
    """csrc/slstm.cu's cluster route in plain torch: per (head, group) a
    cluster whose CTAs each hold their columns of r; every step each CTA
    sums its columns' dot products for the group's rows from the h every
    CTA wrote the step before, then the cell update (rounded as the
    kernel rounds it: each product, sum and quotient)."""
    B, S, W = xs[0].shape
    H, hb = rs[0].shape[0], rs[0].shape[1]
    out = torch.empty((B, S, W))
    for head in range(H):
        for b0, b1 in sl.plan_groups(plan, B):
            rows = b1 - b0
            h = torch.zeros((rows, hb))
            c, n, m = (torch.zeros((rows, hb)), torch.ones((rows, hb)),
                       torch.zeros((rows, hb)))
            for t in range(S):
                h_new = torch.empty((rows, hb))
                for j0, j1 in sl.plan_columns(plan, hb):
                    z = [xs[g][b0:b1, t, head * hb + j0:head * hb + j1]
                         .float() + h @ rs[g][head, :, j0:j1]
                         for g in range(4)]
                    zi, zf, zz, zo = z
                    fm = zf + m[:, j0:j1]
                    m_new = torch.maximum(fm, zi)
                    ie, fe = torch.exp(zi - m_new), torch.exp(fm - m_new)
                    c[:, j0:j1] = fe * c[:, j0:j1] + ie * torch.tanh(zz)
                    n[:, j0:j1] = fe * n[:, j0:j1] + ie
                    m[:, j0:j1] = m_new
                    sig = 1.0 / (1.0 + torch.exp(-zo))
                    h_new[:, j0:j1] = sig * c[:, j0:j1] / torch.clamp(
                        n[:, j0:j1], min=1e-6)
                h = h_new  # every CTA's columns, after the cluster barrier
                out[b0:b1, t, head * hb:(head + 1) * hb] = h
    return out.to(xs[0].dtype)


@pytest.mark.parametrize("B,S,H,hb", [(8, 12, 2, 24), (3, 7, 3, 40),
                                      (5, 9, 1, 36), (1, 10, 2, 16)])
def test_cluster_model_matches_plain_version(B, S, H, hb):
    rng = np.random.default_rng(B * S + hb)
    W = H * hb
    xs = [torch.from_numpy(rng.standard_normal((B, S, W)).astype(np.float32))
          for _ in range(4)]
    rs = [torch.from_numpy((0.2 * rng.standard_normal((H, hb, hb)))
                           .astype(np.float32)) for _ in range(4)]
    plan = sl.slstm_plan(B, H, hb)
    # the same model over the train shape's grouping and cluster
    for p in (plan, sl.SLSTMPlan("cluster", min(8, hb), -(-hb // min(8, hb)),
                                 2)):
        got = cluster_model(xs, rs, p)
        want, _ = ref.naive_slstm(*xs, *rs)
        torch.testing.assert_close(got, want, **SLSTM_TOL)
