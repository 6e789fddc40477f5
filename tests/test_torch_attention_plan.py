"""The attention kernels' host-side choices, and the arithmetic of the
flash kernel's two tensor-core routes, on the CPU.

The CUDA kernels themselves run only on a card (``tests/test_torch_gpu.py``
and ``chip_smoke.py``); what decides how they run is Python and is tested
here: the flash kernel's route as a function of (dtype, D), the tf32x3
route's tile plan, the decode kernel's cluster plan, and plain-torch models
of both routes' arithmetic held against ``ref.naive_attention``: the
``wgmma`` route's (bf16 products summed in float32, the scale applied
after the product, softmax weights fed to the P.V product as bf16 hi +
lo) and the tf32x3 route's (every operand as tf32 hi + lo, three products
each into truncating float32 accumulators started fresh for each 32-column
box of S and each tile's P.V, P.V summed in the kernel's key order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

# -- the flash kernel's route --------------------------------------------------

ROUTES = [  # (dtype, D, route)
    *[(torch.bfloat16, D, "wgmma") for D in (16, 32, 48, 64, 128, 144, 256)],
    *[(torch.bfloat16, D, "tf32x3") for D in (1, 8, 20, 40, 200, 250)],
    *[(torch.float32, D, "tf32x3") for D in (16, 20, 32, 64, 128, 200, 256)],
]


@pytest.mark.parametrize("dtype,D,want", ROUTES)
def test_flash_route_is_a_function_of_dtype_and_head_dim(dtype, D, want):
    """bf16 with D % 16 == 0 runs bf16 products; float32, and bf16 with
    another D, split tf32 products (one TF32 product would round float32
    to a 10-bit mantissa)."""
    assert fa.route(dtype, D) == want
    assert fa.route(dtype, D) == fa.route(dtype, D)


@pytest.mark.parametrize("dtype,D", [(torch.float16, 64), (torch.float32, 0),
                                     (torch.bfloat16, 288)])
def test_flash_route_refuses_what_neither_route_takes(dtype, D):
    with pytest.raises(ValueError):
        fa.route(dtype, D)


# -- the decode kernel's cluster plan -------------------------------------------

PLAN_SHAPES = [  # (B, Hkv, g, D, itemsize): chip_smoke.py's decode cases
    (1, 4, 2, 32, 4),     # main: the paper consumer's cache
    (8, 5, 3, 64, 2),     # launch.serve: smollm_360m
    (3, 3, 4, 48, 4),     # ragged
    (2, 2, 4, 64, 2),     # ragged-bf16
    (8, 1, 10, 256, 2),   # recurrentgemma_2b: MQA, D 256
    (2, 1, 10, 256, 4),   # rg-ring-f32
    (3, 1, 12, 200, 4),   # d200-g12
    (3, 2, 2, 20, 4),     # the smoke models' head dim 20
    (3, 2, 2, 20, 2),     # ... in bf16: rows not a multiple of 16 bytes
    (2, 1, 3, 20, 4),     # qs-serve: torch_quickstart.py's serve part
    (2, 2, 2, 16, 4),     # engine: torch_serving_engine_migration.py
]
PLAN_S = [1, 31, 32, 100, 128, 777, 1000, 2048, 2560]


def warp_slots(plan, rank: int, warp: int, S: int) -> range:
    """The cache slots that warp ``warp`` of CTA ``rank`` reads, as the
    kernel computes them (csrc/decode_attention.cu: w0, w1)."""
    lo = min(S, (rank * da.WARPS + warp) * plan.keys_per_warp)
    return range(lo, min(S, lo + plan.keys_per_warp))


@pytest.mark.parametrize("S", PLAN_S)
@pytest.mark.parametrize("B,Hkv,g,D,itemsize", PLAN_SHAPES)
def test_decode_plan_covers_every_slot_once_in_rank_order(B, Hkv, g, D,
                                                          itemsize, S):
    plan = da.decode_plan(B, S, Hkv, g, D, itemsize)
    assert plan == da.decode_plan(B, S, Hkv, g, D, itemsize)  # pure
    walk = [s for rank in range(plan.cluster) for warp in range(da.WARPS)
            for s in warp_slots(plan, rank, warp, S)]
    assert walk == list(range(S))
    assert 1 <= plan.cluster <= da.MAX_CLUSTER
    assert all(warp_slots(plan, rank, 0, S) for rank in range(plan.cluster))
    # a warp's keys are whole loads of its lane groups
    lanes, vec = plan.lanes_per_key, plan.vec
    assert plan.keys_per_warp % (32 // lanes) == 0
    # the heads: balanced tiles of at most MAX_HEADS
    assert plan.heads_per_tile <= da.MAX_HEADS
    assert (plan.n_tiles - 1) * plan.heads_per_tile < g
    assert plan.n_tiles * plan.heads_per_tile >= g
    # a row's pieces: 16 bytes where D allows, else one element by the
    # whole warp; the kernel's lanes hold at most 2 pieces of 16 bytes or
    # 8 elements each, and its lane groups are 4, 8, 16 or 32 lanes
    assert D % vec == 0 and vec in (1, 16 // itemsize)
    assert (vec * itemsize == 16) == (D * itemsize % 16 == 0)
    pieces = D // vec
    assert pieces <= lanes * (2 if vec == 4 else 1 if vec == 8 else 8)
    assert lanes in (4, 8, 16, 32) and (vec > 1 or lanes == 32)
    assert lanes == 32 or lanes >= pieces
    # one wave: clusters of several CTAs on at most 3/4 of the SMs
    ctas = B * Hkv * plan.n_tiles * plan.cluster
    assert ctas <= (da.SMS if plan.cluster == 1 else 3 * da.SMS // 4) or (
        plan.n_tiles == -(-g // da.MAX_HEADS))


def test_decode_plan_at_the_main_shapes():
    """The paper consumer's cache: 8 lanes a key (16-byte float32 loads),
    a cluster of 8 CTAs of 8 warps, 32 keys a warp, one query head a tile
    (two tiles of 64 CTAs score half the pairs a warp that one tile of two
    heads would); recurrentgemma's serving cache, D 256 bf16: a whole warp
    a key, its 10 heads over one kv head in 10 tiles of one CTA each (80
    CTAs, 16 keys a warp)."""
    main = da.decode_plan(1, 2048, 4, 2, 32, 4)
    assert main == da.DecodePlan(cluster=8, keys_per_warp=32,
                                 heads_per_tile=1, n_tiles=2,
                                 lanes_per_key=8, vec=4)
    rg = da.decode_plan(8, 128, 1, 10, 256, 2)
    assert rg == da.DecodePlan(cluster=1, keys_per_warp=16, heads_per_tile=1,
                               n_tiles=10, lanes_per_key=32, vec=8)


# -- a plain model of the wgmma route's arithmetic ------------------------------

# bf16 cases of chip_smoke.py:FLASH_CASES with D % 16 == 0, at their head
# dims and masks, cut to few rows and heads: (B, Sq, Sk, H, Hkv, D, window)
MODEL_CASES = [
    (1, 128, 128, 3, 1, 64, 0),      # smollm-train
    (1, 32, 32, 3, 1, 64, 0),        # smollm-prefill
    (1, 128, 128, 2, 2, 64, 64),     # sweep, window 64
    (1, 96, 96, 4, 1, 128, 0),       # sweep, D 128
    (1, 128, 128, 2, 1, 32, 0),      # sweep, D 32
    (1, 160, 160, 2, 1, 64, 40),     # first-tile-masked
    (2, 32, 32, 2, 1, 256, 2048),    # rg-prefill
    (1, 160, 160, 2, 1, 256, 128),   # rg-long-prefill, the window biting
]
# Against the plain version computed in float32 on the same bf16 values:
# with P as hi + lo the model keeps about 16 bits of each weight and sits
# 2.7e-6 to 5.4e-6 away at these cases (the output is a convex mix of
# N(0,1) values); with single-bf16 P (8 bits) it is 2^-9 relative per
# weight away, 2.0e-3 to 2.9e-3.  The model must be within 2e-5 and at
# least 100x closer with hi + lo.
MODEL_TOL = 2e-5


def wgmma_model(q, k, v, *, window: int, hi_lo: bool):
    """The wgmma route's arithmetic in plain torch: bf16 products summed in
    float32, s = scale * (q.k), a float32 softmax whose unnormalized
    weights feed P.V as bf16 (hi, and lo = bf16(P - hi)), the row sum
    taken in float32.  Returns float32."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.float().reshape(B, Sq, Hkv, g, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * ref.attn_scale(D)
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    keep = qp >= kp
    if window:
        keep &= qp - kp < window
    s = torch.where(keep, s, ref.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    hi = p.bfloat16().float()
    o = torch.einsum("bhgqk,bkhd->bqhgd", hi, v.float())
    if hi_lo:
        lo = (p - hi).bfloat16().float()
        o = o + torch.einsum("bhgqk,bkhd->bqhgd", lo, v.float())
    o = o / p.sum(-1).permute(0, 3, 1, 2)[..., None]
    return o.reshape(B, Sq, H, D)


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,window", MODEL_CASES)
def test_wgmma_arithmetic_model_matches_plain_and_needs_hi_lo(B, Sq, Sk, H,
                                                             Hkv, D, window):
    rng = np.random.default_rng(D * 1000 + Sq + window)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .bfloat16() for shape in ((B, Sq, H, D), (B, Sk, Hkv, D),
                                         (B, Sk, Hkv, D)))
    assert fa.route(q.dtype, D) == "wgmma"
    want = ref.naive_attention(q.float(), k.float(), v.float(), causal=True,
                               window=window)
    hi_lo = wgmma_model(q, k, v, window=window, hi_lo=True)
    single = wgmma_model(q, k, v, window=window, hi_lo=False)
    err = (hi_lo - want).abs().max().item()
    err_single = (single - want).abs().max().item()
    assert err <= MODEL_TOL, err
    assert 100 * err < err_single, (err, err_single)
    # in the working type the model is the plain version's output
    torch.testing.assert_close(hi_lo.bfloat16().float(),
                               ref.naive_attention(q, k, v, causal=True,
                                                   window=window).float(),
                               rtol=2e-2, atol=2e-2)


# -- the tf32x3 route's plan -----------------------------------------------------

def test_flash_f32_plan_fits_every_head_dim():
    """For every D of 1..256: pure; D padded to whole 32-column boxes (a
    multiple of tf32's depth of 8), every tile within a block's shared
    memory, and the registers that hold the next tile (keys / 4 rows of
    cols / 32 columns a lane, K and V) at most 64 a thread."""
    for D in range(1, fa.MAX_HEAD_DIM + 1):
        plan = fa.flash_f32_plan(D)
        assert plan == fa.flash_f32_plan(D)
        assert plan.cols % 32 == 0 and D <= plan.cols < D + 32, D
        assert plan.groups in (1, 2) and plan.keys in (16, 32), D
        assert plan.smem_bytes <= fa.SMEM_PER_BLOCK, D
        held = 2 * (plan.keys // 4) * (plan.cols // 32)
        assert not plan.prefetch or held <= 64, D


def test_flash_f32_plan_at_the_path_shapes():
    """The paths' head dims: 20 (the examples), 32 (the paper consumer),
    64 (whisper's float32 gate): two warpgroups on 32-key tiles, the next
    one loaded during the products; 256 (recurrentgemma's float32 gate):
    one warpgroup on 16-key tiles in 230,400 bytes, where 32 keys would
    need 263,168."""
    assert fa.flash_f32_plan(20) == fa.F32Plan(32, 2, 32, True, 50176)
    assert fa.flash_f32_plan(32) == fa.flash_f32_plan(20)
    assert fa.flash_f32_plan(64) == fa.F32Plan(64, 2, 32, True, 99328)
    assert fa.flash_f32_plan(256) == fa.F32Plan(256, 1, 16, False, 230400)
    assert 1024 + 8 * (64 * 256 + 2 * 32 * 256) > fa.SMEM_PER_BLOCK
    with pytest.raises(ValueError):
        fa.flash_f32_plan(257)


# -- a plain model of the tf32x3 route's arithmetic -----------------------------

def tf32(x):
    """Round float32 to tf32 as cvt.rna.tf32.f32 does: to nearest, ties
    away from zero, on the 13 low mantissa bits (the bits are sign and
    magnitude, so adding half an ulp to them rounds the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def bf16(x):
    return x.bfloat16().float()


def split3(rnd):
    """hi = rnd(x), lo = rnd(x - hi): three products lo.hi + hi.lo + hi.hi."""
    def split(x):
        hi = rnd(x)
        return hi, rnd(x - hi)
    return split


def split1(x):
    """One TF32 product: hi.hi, lo = 0."""
    return tf32(x), torch.zeros_like(x)


def slot_order(n: int) -> list:
    """Keys 0..n-1 of a kv tile in the order of their V^T slots: within a
    group of 8, slot (j / 2) + 4 (j % 2) holds key j (the tf32 A
    fragment's columns c and c + 4 are the score fragment's 2c and
    2c + 1)."""
    slot = [(j & ~7) | ((j & 7) >> 1) | ((j & 1) << 2) for j in range(n)]
    return sorted(range(n), key=slot.__getitem__)


def truncating_product(a, b, acc=None):
    """acc + a [..., M, K] @ b [..., N, K]^T as a tensor core's float32
    accumulator is modelled here: the exact sum of each k-step's 8 products
    added to the accumulator, and the result truncated toward zero to
    float32."""
    shape = a.shape[:-1] + b.shape[-2:-1]
    acc = (torch.zeros(shape) if acc is None else acc).double()
    for k0 in range(0, a.shape[-1], 8):
        x = acc + (a[..., k0:k0 + 8].double()
                   @ b[..., k0:k0 + 8].double().transpose(-1, -2))
        y = x.float().double()
        acc = torch.where(y.abs() > x.abs(),
                          torch.nextafter(y.float(), torch.zeros(())).double(),
                          y)
    return acc.float()


def tf32x3_model(q, k, v, *, causal: bool, window: int, split):
    """The tf32x3 route's arithmetic in plain torch, float32, CTA by CTA
    (64 query rows): q scaled in float32, D padded with zeros to the plan's
    32-column boxes, every operand split by ``split`` into (hi, lo); the kv
    tiles the kernel walks (``flash_f32_plan(D).keys`` keys, wholly masked
    ones skipped) taken in turn by the plan's warpgroups from the first
    walked one, each with its own online softmax (masked scores NEG_INF,
    keys past Sk out).  S: each 32-column box as lo.hi + hi.lo + hi.hi in
    one fresh truncating accumulator (``truncating_product``), the boxes
    added in float32; P.V: each 32-column piece of D as lo.hi + hi.lo +
    hi.hi over the tile's keys in slot order, in one fresh truncating
    accumulator, then o = fma(o, corr, it); the warpgroups merged at the
    end; the output acc / max(l, 1e-37)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    plan = fa.flash_f32_plan(D)
    keys, cols = plan.keys, plan.cols

    def pad(x):
        return torch.nn.functional.pad(x.float(), (0, cols - D))

    qs = pad(q.float() * ref.attn_scale(D)).reshape(B, Sq, Hkv, g, cols)
    qs = qs.permute(0, 2, 3, 1, 4)  # [B, Hkv, g, Sq, cols]
    kf = pad(k).permute(0, 2, 1, 3)[:, :, None]  # [B, Hkv, 1, Sk, cols]
    vf = pad(v).permute(0, 2, 1, 3)[:, :, None]
    (q_hi, q_lo), (k_hi, k_lo), (v_hi, v_lo) = split(qs), split(kf), split(vf)
    kp = torch.arange(Sk)[None, :]
    out = torch.zeros((B, Hkv, g, Sq, D))
    for q0 in range(0, Sq, 64):
        rows = slice(q0, min(q0 + 64, Sq))
        q_last = rows.stop - 1
        qp = torch.arange(q0, rows.stop)[:, None]
        keep = torch.ones((rows.stop - q0, Sk), dtype=torch.bool)
        if causal:
            keep &= qp >= kp
        if window:
            keep &= qp - kp < window
        nk = -(-Sk // keys)
        t_lo, t_hi = 0, nk
        if not (window > 0 and q_last - (Sk - 1) >= window):
            if causal:
                t_hi = min(nk, q_last // keys + 1)
            if window > 0:
                t_lo = max(0, q0 - window + 1) // keys
        shape = (B, Hkv, g, rows.stop - q0)
        state = [[torch.full(shape, ref.NEG_INF), torch.zeros(shape),
                  torch.zeros(shape + (cols,))] for _ in range(plan.groups)]
        for t in range(t_lo, t_hi):
            m, l, o = state[(t - t_lo) % plan.groups]
            ks = slice(t * keys, min((t + 1) * keys, Sk))
            s = None
            for c0 in range(0, cols, 32):
                c = slice(c0, c0 + 32)
                box = None
                for a, b in ((q_lo, k_hi), (q_hi, k_lo), (q_hi, k_hi)):
                    box = truncating_product(a[..., rows, c], b[..., ks, c],
                                             box)
                s = box if s is None else s + box
            s = torch.where(keep[:, ks], s, ref.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            order = [ks.start + j for j in slot_order(ks.stop - ks.start)]
            p_hi, p_lo = split(p[..., [j - ks.start for j in order]])
            vt_hi = v_hi[..., order, :].transpose(-1, -2)
            vt_lo = v_lo[..., order, :].transpose(-1, -2)
            o = o.clone()
            for c0 in range(0, cols, 32):
                c = slice(c0, c0 + 32)
                pv = None
                for a, b in ((p_lo, vt_hi), (p_hi, vt_lo), (p_hi, vt_hi)):
                    pv = truncating_product(a, b[..., c, :], pv)
                o[..., c] = (o[..., c].double() * corr[..., None].double()
                             + pv.double()).float()  # one rounding: fmaf
            state[(t - t_lo) % plan.groups] = [m_new, l, o]
        m, l, o = state[0]
        for m1, l1, o1 in state[1:]:  # the merge: both to the larger m
            mm = torch.maximum(m, m1)
            f0, f1 = torch.exp(m - mm), torch.exp(m1 - mm)
            l = l * f0 + l1 * f1
            o = o * f0[..., None] + o1 * f1[..., None]
        out[..., rows, :] = o[..., :D] / l.clamp_min(1e-37)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


def attention64(q, k, v, *, causal: bool, window: int):
    """The plain version in float64, from the same float32 inputs."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = (q.double() * ref.attn_scale(D)).reshape(B, Sq, Hkv, H // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double())
    qp, kp = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
    keep = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        keep &= qp >= kp
    if window:
        keep &= qp - kp < window
    p = torch.softmax(torch.where(keep, s, ref.NEG_INF), dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v.double()).reshape(
        B, Sq, H, D)


def drift(got, want):
    """sum((got - want) * want) / sum(want * want): a bias along want."""
    got, want = got.double(), want.double()
    return float(((got - want) * want).sum() / (want * want).sum())


# float32 cases of chip_smoke.py:FLASH_CASES, cut to few rows and heads,
# and whisper's float32 gate shape cut to one head of 64 rows:
# (label, B, Sq, Sk, H, Hkv, D, causal, window)
TF32X3_CASES = [
    ("paper-train", 1, 128, 128, 2, 1, 32, True, 0),
    ("qs-train", 1, 64, 64, 3, 1, 20, True, 0),
    ("rg-remat-f32", 1, 32, 32, 2, 1, 256, True, 2048),
    ("d200-ragged", 1, 77, 77, 2, 1, 200, True, 0),
    ("no-valid-key", 1, 128, 48, 2, 1, 16, True, 16),
    ("first-tile-masked", 1, 160, 160, 2, 1, 64, True, 40),
    ("wh-gate-f32-encoder", 1, 64, 1500, 1, 1, 64, False, 0),
]
FLASH_TOL = dict(rtol=1e-5, atol=1e-5)  # chip_smoke.py:FLASH_TOL
FLASH_DRIFT = 1e-6  # chip_smoke.py:FLASH_DRIFT


@pytest.mark.parametrize("label,B,Sq,Sk,H,Hkv,D,causal,window", TF32X3_CASES)
def test_tf32x3_arithmetic_model_keeps_float32_accuracy(label, B, Sq, Sk, H,
                                                        Hkv, D, causal,
                                                        window):
    """The model of the kernel's arithmetic (truncating accumulators
    included) lies within the kernel check's float32 tolerance of the
    plain version, at least 100x closer than one TF32 product (so the
    check can tell TF32 from a sound kernel) and at least 5x closer than a
    3 x bf16 split; its drift along the
    output against a float64 version is within the kernel check's
    FLASH_DRIFT."""
    rng = np.random.default_rng(D * 1000 + Sq + window)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    assert fa.route(q.dtype, D) == "tf32x3"
    want = ref.naive_attention(q, k, v, causal=causal, window=window)
    errs = {}
    for name, split in (("tf32x3", split3(tf32)), ("tf32", split1),
                        ("bf16x3", split3(bf16))):
        got = tf32x3_model(q, k, v, causal=causal, window=window, split=split)
        assert bool(torch.isfinite(got).all()), name
        errs[name] = (got - want).abs().max().item()
        if name == "tf32x3":
            torch.testing.assert_close(got, want, **FLASH_TOL)
            bias = drift(got, attention64(q, k, v, causal=causal,
                                          window=window))
            assert abs(bias) <= FLASH_DRIFT, bias
    assert 100 * errs["tf32x3"] < errs["tf32"], errs
    assert 5 * errs["tf32x3"] < errs["bf16x3"], errs


def test_tf32_rounds_to_nearest_ties_away():
    """The model's tf32 rounding: 10 mantissa bits kept, a tie rounds away
    from zero for either sign, and x - tf32(x) is exact."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -20,
                      1 + 1.5 * ulp, 3.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0])
    assert torch.equal(tf32(x), want)
    hi = tf32(x)
    assert torch.equal((x - hi) + hi, x)
    assert torch.equal(tf32(hi), hi)


def test_tf32x3_pv_sum_starts_fresh_each_tile():
    """Why the tf32x3 route adds each tile's P.V to o on the CUDA cores:
    with products into one truncating accumulator over whisper's 1500
    keys (a head of 64 rows, D 64, 32-key tiles) the output drifts toward
    zero by about 1e-5 of itself: within FLASH_TOL element by element,
    but a bias that whisper's float32 gradient gate sees in its loss; a
    fresh accumulator each tile keeps the drift 10x smaller."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((64, 64), (1500, 64), (1500, 64)))
    want = ref.naive_attention(q[None, :, None], k[None, :, None],
                               v[None, :, None], causal=False)[0, :, 0]
    split = split3(tf32)
    qh, ql = split(q * ref.attn_scale(64))
    drift = {}
    for fresh in (False, True):
        m = torch.full((64,), ref.NEG_INF)
        l, o = torch.zeros(64), torch.zeros((64, 64))
        for k0 in range(0, 1500, fa.flash_f32_plan(64).keys):
            kt, vt = k[k0:k0 + 32], v[k0:k0 + 32]
            (kh, kl), (vh, vl) = split(kt), split(vt)
            s = truncating_product(ql, kh)
            s = truncating_product(qh, kh, truncating_product(qh, kl, s))
            m_new = torch.maximum(m, s.amax(-1))
            corr, p = torch.exp(m - m_new), torch.exp(s - m_new[:, None])
            l = l * corr + p.sum(-1)
            ph, pl = split(p)
            if fresh:
                pv = None
                for a, b in ((pl, vh), (ph, vl), (ph, vh)):
                    pv = truncating_product(a, b.T.contiguous(), pv)
                o = o * corr[:, None] + pv
            else:  # one accumulator: the running o itself
                o = o * corr[:, None]
                for a, b in ((pl, vh), (ph, vl), (ph, vh)):
                    o = truncating_product(a, b.T.contiguous(), o)
            m = m_new
        got = o / l[:, None]
        drift[fresh] = float(((got - want) * want).sum() / (want * want).sum())
        if fresh:
            torch.testing.assert_close(got, want, **FLASH_TOL)
    assert drift[False] < -5e-6, drift
    assert 10 * abs(drift[True]) < abs(drift[False]), drift
