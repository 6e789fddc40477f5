"""The attention kernels' host-side choices, and the arithmetic of the
flash kernel's tensor-core route, on the CPU.

The CUDA kernels themselves run only on a card (``tests/test_torch_gpu.py``
and ``chip_smoke.py``); what decides how they run is Python and is tested
here: the flash kernel's route as a function of (dtype, D), the decode
kernel's cluster plan, and a plain-torch model of the ``wgmma`` route's
arithmetic (bf16 products summed in float32, the scale applied after the
product, softmax weights fed to the P.V product as bf16 hi + lo) held
against ``ref.naive_attention``.
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
    *[(torch.bfloat16, D, "float32") for D in (1, 8, 20, 40, 200, 250)],
    *[(torch.float32, D, "float32") for D in (16, 20, 32, 64, 128, 200, 256)],
]


@pytest.mark.parametrize("dtype,D,want", ROUTES)
def test_flash_route_is_a_function_of_dtype_and_head_dim(dtype, D, want):
    """bf16 with D % 16 == 0 runs on the tensor cores; float32 never does
    (they would round its products to TF32), nor bf16 with another D."""
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
