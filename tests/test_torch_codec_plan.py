"""The fused codec kernels' grids (``codec.codec_plan``) and plain-torch
models of how each route combines its partial lanes, on the CPU.

The CUDA kernels (``csrc/codec.cu``) run only on a card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``).  What decides which
words each of their threads reads and writes is the plan, computed here in
Python, and the index arithmetic of the kernels, modelled here in numpy:

  * every (row, 16-byte piece) of every chunk is read once, and every XOR
    word, ``q`` block and ``scale`` entry is written once;
  * no int8 plan splits a quant block (two rows) between CTAs or warps;
  * an odd row count's missing last row, read as zeros, gives
    ``pair_rows``' outputs;
  * the routes' combines (a cluster's runs summed in its first CTA; q and
    scale alone, then the fingerprint kernel over the unpadded words) give
    ``xor_fp_ref`` and ``int8_fp_ref`` bit for bit, and the JAX package's
    ``repro.kernels.codec`` on the same seeded numpy words.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import codec as jck
from repro_torch.kernels import codec as ck
from repro_torch.kernels import fingerprint as fp
from tools.profile_torch_codec import sweep_plans

PIECES = fp.ROW_PIECES


def _grid(plan, C):
    """The flat grid of csrc/codec.cu: (run, slice, first chunk) of every
    CTA, CTA x = (group * slices + slice) * runs + run."""
    slices = PIECES // plan.pieces
    x = np.arange(plan.runs * slices * -(-C // plan.groups))
    return (x % plan.runs, x // plan.runs % slices,
            x // plan.runs // slices * plan.groups)


def xor_access(plan, C, R):
    """-> (reads, writes) [C, R, 32] of the XOR kernel, and the CTA whose
    thread reads each (chunk, row, piece): thread t of CTA x serves chunk
    c0 + t // tpg, piece slice * pieces + t' % pieces of rows
    r0 + t' // pieces + per_round k below the run's end."""
    run, sl, c0 = _grid(plan, C)
    tpg = fp.THREADS // plan.groups
    t = np.arange(fp.THREADS)
    c = c0[:, None] + t[None, :] // tpg
    tt = t % tpg
    per_round = tpg // plan.pieces
    r0 = run * plan.rows_per_cta
    r1 = np.where(c < C, np.minimum(R, r0[:, None] + plan.rows_per_cta),
                  r0[:, None])
    first = r0[:, None] + tt[None, :] // plan.pieces
    piece = sl[:, None] * plan.pieces + tt[None, :] % plan.pieces
    reads = np.zeros((C, R, PIECES), np.int64)
    writes = np.zeros_like(reads)
    owner = np.full((C, R, PIECES), -1, np.int64)
    x = np.broadcast_to(np.arange(len(run))[:, None], c.shape)
    for k in range(-(-plan.rows_per_cta // per_round)):
        rr = first + per_round * k
        ok = rr < r1
        idx = (c[ok], rr[ok], piece[ok])
        np.add.at(reads, idx, 1)
        np.add.at(writes, idx, 1)
        owner[idx] = x[ok]
    return reads, writes, owner


def int8_access(plan, C, R):
    """-> (row reads [C, R, 32], q/scale writes [C, nb], the (CTA, warp)
    of each quant block) of the int8 kernel: warp w of CTA x serves chunk
    c0 + w // wpg, quant blocks run * bpc + w % wpg + wpg k below the
    run's end; its 32 lanes read all 32 pieces of rows 2b and
    2b + 1 (the latter only below R)."""
    run, _, c0 = _grid(plan, C)
    nb = -(-R // 2)
    bpc = plan.rows_per_cta // 2
    wpg = ck.WARPS // plan.groups
    w = np.arange(ck.WARPS)
    c = c0[:, None] + w[None, :] // wpg
    b0 = run * bpc
    b1 = np.where(c < C, np.minimum(nb, b0[:, None] + bpc), b0[:, None])
    first = b0[:, None] + w[None, :] % wpg
    reads = np.zeros((C, R, PIECES), np.int64)
    writes = np.zeros((C, nb), np.int64)
    owner = np.full((C, nb), -1, np.int64)
    x = np.broadcast_to(np.arange(len(run))[:, None], c.shape)
    for k in range(-(-bpc // wpg)):
        bb = first + wpg * k
        ok = bb < b1
        cc, b = c[ok], bb[ok]
        np.add.at(writes, (cc, b), 1)
        owner[cc, b] = (x * ck.WARPS + w[None, :])[ok]
        reads[cc, 2 * b] += 1
        second = 2 * b + 1 < R
        reads[cc[second], 2 * b[second] + 1] += 1
    return reads, writes, owner


def lane_writes(plan, C):
    """How often the cluster route writes each (chunk, piece) lane word:
    thread t < groups * pieces of each cluster's first CTA (run 0), for
    its chunk below C."""
    run, sl, c0 = _grid(plan, C)
    first = run == 0
    t = np.arange(plan.groups * plan.pieces)
    c = c0[first][:, None] + t[None, :] // plan.pieces
    piece = sl[first][:, None] * plan.pieces + t[None, :] % plan.pieces
    count = np.zeros((C, PIECES), np.int64)
    ok = c < C
    np.add.at(count, (c[ok], piece[ok]), 1)
    return count


def check_plan(C, R, kind, plan=None):
    if plan is None:
        plan = ck.codec_plan(C, R, kind)
        assert plan == ck.codec_plan(C, R, kind)  # pure
        assert plan.groups <= C
    assert PIECES % plan.pieces == 0 and plan.groups in (1, 2, 4, 8)
    assert plan.route in ck.ROUTES and plan.runs >= 1
    if plan.route == "cluster":
        assert plan.runs <= fp.MAX_RUNS  # one cluster
    assert plan.runs * plan.rows_per_cta >= R
    if plan.groups > 1:
        assert plan.runs == 1
    if kind == "xor":
        assert plan.route == "cluster"
        reads, writes, _ = xor_access(plan, C, R)
        assert (reads == 1).all() and (writes == 1).all()
        assert (lane_writes(plan, C) == 1).all()
        return plan
    assert plan.pieces == PIECES and plan.rows_per_cta % 2 == 0
    reads, writes, owner = int8_access(plan, C, R)
    assert (reads == 1).all() and (writes == 1).all()
    # a quant block belongs to one warp of one CTA, and its two rows to it
    assert (owner >= 0).all()
    if plan.route == "cluster":
        assert (lane_writes(plan, C) == 1).all()
    return plan


@settings(max_examples=40, deadline=None)
@given(C=st.integers(1, 64), R=st.integers(1, 2000),
       kind=st.sampled_from(ck.KINDS))
def test_plan_reads_every_row_and_piece_once(C, R, kind):
    check_plan(C, R, kind)


@settings(max_examples=15, deadline=None)
@given(C=st.integers(500, 1100), R=st.integers(1, 6),
       kind=st.sampled_from(ck.KINDS))
def test_plan_for_many_short_chunks(C, R, kind):
    check_plan(C, R, kind)


# the fold's 4 MiB chunk, the trainer pre-copy's 64 KiB leaves, the serving
# grid, small leaves, ragged odd-R shapes and one-row chunks
NAMED = [(1, 8192), (64, 128), (32, 128), (16, 128), (8, 128), (1024, 4),
         (1, 8), (1, 2), (3, 77), (2, 1), (5, 129)]


@pytest.mark.parametrize("C,R", NAMED)
@pytest.mark.parametrize("kind", ck.KINDS)
def test_plan_at_named_shapes(C, R, kind):
    check_plan(C, R, kind)


@pytest.mark.parametrize("C,R", [(64, 128), (8, 128), (1024, 4), (1, 2),
                                 (3, 77), (1, 1000)])
@pytest.mark.parametrize("kind", ck.KINDS)
def test_every_swept_plan_reads_once(C, R, kind):
    """The plans ``tools/profile_torch_codec.py --sweep`` times, and the GPU
    tests force, cover every word once as well."""
    plans = sweep_plans(C, R, kind)
    assert plans and ck.codec_plan(C, R, kind) in plans
    for plan in plans:
        check_plan(C, R, kind, plan)


def test_plans_fill_the_card():
    """The serving grid: 4 chunks a CTA, every warp on a quant block; the
    fold: more CTAs than SMs on both kernels."""
    serving = ck.codec_plan(1024, 4, "int8")
    assert serving.groups == 4 and serving.runs == 1
    for kind in ck.KINDS:
        fold = ck.codec_plan(1, 8192, kind)
        slices = PIECES // fold.pieces
        assert fold.runs * slices >= ck.CTA_TARGET, (kind, fold)


def test_plan_refuses_nonsense():
    with pytest.raises(ValueError):
        ck.codec_plan(0, 8, "xor")
    with pytest.raises(ValueError):
        ck.codec_plan(1, 8, "rle")


# ---------------------------------------------------------------------------
# the routes' arithmetic
# ---------------------------------------------------------------------------

def _words(C, R, seed):
    """float32 words (with a dirty stripe and a few special values in the
    parent) as int32 bits, and the same as numpy uint32."""
    rng = np.random.default_rng(seed)
    cur = rng.standard_normal((C, R, 128)).astype(np.float32)
    par = cur.copy()
    par[:, R // 3: R // 3 + max(1, R // 5)] += rng.standard_normal(
        (C, min(R, R // 3 + max(1, R // 5)) - R // 3, 128)).astype(np.float32)
    par[0, 0, :3] = [np.inf, -0.0, 1e-39]
    return (torch.from_numpy(cur.view(np.int32).copy()),
            torch.from_numpy(par.view(np.int32).copy()),
            cur.view(np.uint32), par.view(np.uint32))


def _weights(R):
    r = torch.arange(1, R + 1, dtype=torch.int64)
    return fp._mix32(fp._mul32(r, fp._GOLD)) | 1


def model_cta_lanes(cur, plan, rows_of_cta):
    """Partial lanes [CTAs, C, 128] (int64 mod 2^32) of each CTA: the
    weighted sum of the words it reads, ``rows_of_cta(x)`` -> (chunk,
    rows, pieces) it covers."""
    C, R, _ = cur.shape
    u = fp._as_u32_values(cur)
    w = _weights(R)
    run, _, _ = _grid(plan, C)
    parts = []
    for x in range(len(run)):
        part = torch.zeros((C, fp.LANES), dtype=torch.int64)
        for c, rows, pieces in rows_of_cta(x):
            cols = slice(4 * pieces.start, 4 * pieces.stop)
            part[c, cols] = (part[c, cols] + fp._mul32(
                u[c, rows, cols], w[rows, None]).sum(0)) & fp._MASK32
        parts.append(part)
    return torch.stack(parts), run


def combine(parts, run, plan):
    """The cluster route's combine: each cluster's CTAs (the runs of a
    slice) summed in rank order into its first CTA, whose sum is the
    output of its slice and chunks (zero elsewhere)."""
    out = torch.zeros(parts.shape[1:], dtype=torch.int64)
    for x in range(0, len(run), plan.runs):
        total = parts[x].clone()
        for k in range(1, plan.runs):
            total = (total + parts[x + k]) & fp._MASK32
        out = (out + total) & fp._MASK32
    return fp._as_int32_bits(out)


def xor_rows_of_cta(plan, C, R):
    run, sl, c0 = _grid(plan, C)

    def rows_of(x):
        r0 = run[x] * plan.rows_per_cta
        p0 = sl[x] * plan.pieces
        for g in range(plan.groups):
            if c0[x] + g < C:
                yield (c0[x] + g, slice(r0, min(R, r0 + plan.rows_per_cta)),
                       slice(p0, p0 + plan.pieces))
    return rows_of


def int8_rows_of_cta(plan, C, R):
    run, _, c0 = _grid(plan, C)

    def rows_of(x):
        r0 = run[x] * plan.rows_per_cta
        for g in range(plan.groups):
            if c0[x] + g < C:
                yield (c0[x] + g, slice(r0, min(R, r0 + plan.rows_per_cta)),
                       slice(0, PIECES))
    return rows_of


def model_quant(cur, par, plan):
    """q and scale as the int8 kernel writes them: warp by warp over its
    quant blocks, each block two rows, the second read as zeros past R."""
    C, R, _ = cur.shape
    nb = -(-R // 2)
    _, _, owner = int8_access(plan, C, R)
    q = torch.full((C, nb, 256), 99, dtype=torch.int8)
    scale = torch.full((C, nb), 7.0)
    zero = torch.zeros(128, dtype=torch.int32)
    for c in range(C):
        for b in range(nb):
            assert owner[c, b] >= 0
            rows = [cur[c, 2 * b], cur[c, 2 * b + 1] if 2 * b + 1 < R
                    else zero]
            prow = [par[c, 2 * b], par[c, 2 * b + 1] if 2 * b + 1 < R
                    else zero]
            d = (torch.cat(rows).view(torch.float32)
                 - torch.cat(prow).view(torch.float32))
            qb, sb = ck.quant_blocks(d[None])
            q[c, b], scale[c, b] = qb[0], sb[0, 0]
    return q, scale


def _jax_xor(cw, pw):
    lanes, xor = jck.xor_fp_ref(jnp.asarray(cw), jnp.asarray(pw))
    return np.asarray(lanes).view(np.int32), np.asarray(xor).view(np.int32)


def _jax_int8(cw, pw):
    jc, jp = jck.pair_rows(jnp.asarray(cw)), jck.pair_rows(jnp.asarray(pw))
    lanes, q, scale = jck.int8_fp_ref(jc, jp)
    return (np.asarray(lanes).view(np.int32), np.asarray(q).astype(np.int8),
            np.asarray(scale).view(np.int32))


ROUTE_SHAPES = [(1, 300), (3, 77), (5, 4), (2, 1), (9, 33)]


@pytest.mark.parametrize("C,R", ROUTE_SHAPES)
def test_xor_cluster_model_equals_plain_and_jax(C, R):
    cur, par, cw, pw = _words(C, R, seed=C * 100 + R)
    want_lanes, want_xor = ck.xor_fp_ref(cur, par)
    j_lanes, j_xor = _jax_xor(cw, pw)
    assert np.array_equal(want_lanes.numpy(), j_lanes)
    assert np.array_equal(want_xor.numpy(), j_xor)
    plans = {ck.codec_plan(C, R, "xor"),
             ck.CodecPlan("cluster", -(-R // 4), 4, 8, 1),
             ck.CodecPlan("cluster", R, 1, 1, 1)}
    if C > 1:
        plans.add(ck.CodecPlan("cluster", R, 1, 32, 2))
    for plan in plans:
        parts, run = model_cta_lanes(cur, plan, xor_rows_of_cta(plan, C, R))
        assert torch.equal(combine(parts, run, plan), want_lanes), plan
        # each XOR word from the one thread that read it
        _, _, owner = xor_access(plan, C, R)
        assert (owner >= 0).all()
        assert torch.equal(cur ^ par, want_xor)


def _int8_plans(C, R):
    nb = -(-R // 2)
    plans = {ck.codec_plan(C, R, "int8"),
             ck.CodecPlan("split", 2, nb, PIECES, 1),
             ck.CodecPlan("split", 2 * -(-nb // 3), 3, PIECES, 1)}
    for runs in (4, 16):
        plans.add(ck.CodecPlan("cluster", 2 * -(-nb // runs), runs, PIECES, 1))
    if C > 1:
        plans.add(ck.CodecPlan("cluster", 2 * nb, 1, PIECES, 2))
    return plans


@pytest.mark.parametrize("C,R", ROUTE_SHAPES)
def test_int8_route_models_equal_plain_and_jax(C, R):
    """Cluster sums, and quant plus a separate fingerprint of the
    unpadded words: both give the plain version's and the JAX package's
    lanes, q and scale, odd R included."""
    cur, par, cw, pw = _words(C, R, seed=C * 100 + R + 1)
    lanes, q, scale = ck.int8_fp_ref(cur, par)
    j_lanes, j_q, j_scale = _jax_int8(cw, pw)
    assert np.array_equal(lanes.numpy(), j_lanes)
    assert np.array_equal(q.numpy(), j_q)
    assert np.array_equal(scale.view(torch.int32).numpy(), j_scale)
    for plan in _int8_plans(C, R):
        check_plan(C, R, "int8", plan)
        if plan.route == "split":
            got_lanes = fp.fingerprint_lanes_ref(cur)  # no pair_rows
        else:
            parts, run = model_cta_lanes(cur, plan,
                                         int8_rows_of_cta(plan, C, R))
            got_lanes = combine(parts, run, plan)
        got_q, got_scale = model_quant(cur, par, plan)
        assert torch.equal(got_lanes, lanes), plan
        assert torch.equal(got_q, q), plan
        assert torch.equal(got_scale.view(torch.int32),
                           scale.view(torch.int32)), plan


@pytest.mark.parametrize("C,R", [(1, 3), (3, 5), (2, 1), (4, 77)])
def test_odd_rows_read_as_zero_give_pair_rows(C, R):
    """Reading row R of an odd-R chunk as zeros (the kernel, no copies)
    gives ``pair_rows``' outputs (the plain version) and their shapes."""
    cur, par, cw, pw = _words(C, R, seed=R)
    lanes, q, scale = ck.int8_fp_ref(cur, par)
    assert q.shape == (C, (R + 1) // 2, 256) and scale.shape == (C,
                                                                 (R + 1) // 2)
    assert ck.pair_rows(cur).shape[1] == R + 1
    assert torch.equal(fp.fingerprint_lanes_ref(cur), lanes)
    plan = ck.codec_plan(C, R, "int8")
    got_q, got_scale = model_quant(cur, par, plan)
    assert torch.equal(got_q, q)
    assert torch.equal(got_scale.view(torch.int32), scale.view(torch.int32))
    # the tail block's second half is a zero delta: q 0 there
    assert (q[:, -1, 128:] == 0).all()


def test_edge_values_through_the_model():
    e_cur, e_par = ck.edge_blocks()
    cur = torch.from_numpy(e_cur.view(np.int32).reshape(1, -1, 128).copy())
    par = torch.from_numpy(e_par.view(np.int32).reshape(1, -1, 128).copy())
    lanes, q, scale = ck.int8_fp_ref(cur, par)
    for plan in _int8_plans(1, cur.shape[1]):
        got_q, got_scale = model_quant(cur, par, plan)
        assert torch.equal(got_q, q)
        assert torch.equal(got_scale.view(torch.int32),
                           scale.view(torch.int32))
    assert scale.view(torch.int32)[0, 3].item() == 0x7FC00000


@pytest.mark.parametrize("fn", [ck.xor_fp_lanes, ck.int8_fp_lanes])
def test_kernel_wrappers_refuse_cpu_words(fn):
    words = torch.zeros((1, 8, fp.LANES), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fn(words, words)
