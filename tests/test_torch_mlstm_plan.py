"""The mLSTM kernel's host-side choices, and the arithmetic of its
tensor-core route, on the CPU.

The CUDA kernels run only on a card (``tests/test_torch_gpu.py`` and
``chip_smoke.py``); what decides how they run is Python and is tested
here: the route as a function of (dtype, D), the wgmma route's grids and
shared memory (``mlstm.mlstm_plan``), and a plain-torch model of the
wgmma route's arithmetic (bf16 q.k^T summed in float32 with the scale on
the accumulator; S, the carried C and w o V fed to their products as bf16
hi + lo) held against ``ref.chunkwise_mlstm`` and the JAX package's
Pallas kernel in interpret mode.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.mlstm import mlstm as pl_mlstm
from repro_torch.kernels import mlstm as ml
from repro_torch.kernels import ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MLSTM_CASES = _chip_smoke().MLSTM_CASES

# -- the route -----------------------------------------------------------


@pytest.mark.parametrize("case", MLSTM_CASES, ids=[c[0] for c in MLSTM_CASES])
def test_route_of_every_chip_smoke_case(case):
    """bf16 with D % 64 == 0 (xlstm_350m's 512, the sweep's 64) runs on the
    tensor cores; float32 never does (TF32 products), nor bf16 at D 32."""
    label, B, S, H, D, chunk, dtype = case
    want = ("wgmma" if dtype == torch.bfloat16 and D % 64 == 0
            else "float32")
    assert ml.route(dtype, D) == want
    if label.startswith("xl-") and dtype == torch.bfloat16:
        assert want == "wgmma"


@pytest.mark.parametrize("dtype,D", [(torch.float16, 64), (torch.float32, 0),
                                     (torch.bfloat16, 576)])
def test_route_refuses_what_neither_route_takes(dtype, D):
    with pytest.raises(ValueError):
        ml.route(dtype, D)


# -- the plan ------------------------------------------------------------

SMS = 132
# static shared memory of the two wgmma kernels (ptxas on sm_90a: the
# gates, stabilizers and mbarriers), beside the plan's dynamic bytes
OUT_STATIC, STATE_STATIC = 1856, 1584


@pytest.mark.parametrize("D", range(64, 513, 64))
@pytest.mark.parametrize("S,T", [(128, 128), (512, 128), (200, 100),
                                 (16, 4), (64, 64), (96, 32), (1, 1)])
def test_plan_fits_shared_memory_and_covers_every_column(D, S, T):
    B, H = 2, 3
    p = ml.mlstm_plan(B, S, H, D, T)
    assert p == ml.mlstm_plan(B, S, H, D, T)  # pure
    assert p.nb * 64 == D and p.nc * T == S and p.nrt * 64 >= T > (
        p.nrt - 1) * 64
    assert p.out_smem + OUT_STATIC <= ml.SMEM_LIMIT
    assert p.state_smem + STATE_STATIC <= ml.SMEM_LIMIT
    # the output pass's slices of v's columns: at most 4 boxes (2 when it
    # streams C), covering D once, none empty
    cap = 4 if p.nc == 1 else 2
    assert p.nv <= cap and (p.n_dv - 1) * p.nv < p.nb <= p.n_dv * p.nv
    assert p.nk <= 4 and (p.n_dk - 1) * p.nk < p.nb <= p.n_dk * p.nk
    assert p.out_ctas == p.nrt * p.n_dv * p.nc * B * H
    assert p.state_ctas == (p.nb * p.n_dk * B * H if p.nc > 1 else 0)
    assert (p.state_smem == 0) == (p.nc == 1)


def test_plan_at_the_timed_shapes():
    """xl-train: one chunk, one launch of 128 CTAs (32 (b, head) x 2 row
    tiles x 2 halves of v's 512 columns): one wave on 132 SMs.
    xl-4chunks: a state pass of 128 CTAs (8 x 8 row tiles of C x 2
    halves of its columns) and an output pass of 256."""
    train = ml.mlstm_plan(8, 128, 4, 512, 128)
    assert (train.out_ctas, train.state_ctas) == (128, 0) <= (SMS, 0)
    assert (train.nv, train.n_dv, train.out_smem) == (4, 2, 164864)
    four = ml.mlstm_plan(2, 512, 4, 512, 128)
    assert (four.state_ctas, four.out_ctas) == (128, 256)
    assert (four.nv, four.n_dv, four.nk, four.n_dk) == (2, 4, 4, 2)
    assert (four.out_smem, four.state_smem) == (214016, 164864)


# -- a plain model of the wgmma route's arithmetic -----------------------


def _split(x, hi_lo: bool):
    """x as bf16 hi + lo (float32 values), or single bf16 and 0."""
    hi = x.bfloat16().float()
    lo = (x - hi).bfloat16().float() if hi_lo else torch.zeros_like(x)
    return hi, lo


def wgmma_model(q, k, v, i_gate, f_gate, chunk, hi_lo=True):
    """The wgmma route's arithmetic in plain torch, float32 out (before the
    kernel's bf16 rounding of h): q.k^T of the bf16 values in float32,
    scaled after the product; the decay weights and stabilizers in
    float32; S.V, q.C^T and the C update (w o V)^T K with S, C and w o V
    as bf16 hi + lo; C carried in float32 as g C + dC."""
    B, S, H, D = q.shape
    T = min(chunk, S)
    scale = float(np.float32(1.0 / D ** 0.5))
    qt, kt, vt = (x.float().transpose(1, 2) for x in (q, k, v))
    li_all = i_gate.float().transpose(1, 2)
    lf_all = F.logsigmoid(f_gate.float()).transpose(1, 2)
    C = torch.zeros((B, H, D, D))
    n = torch.zeros((B, H, D))
    m = torch.full((B, H), ref.NEG_INF)
    idx = torch.arange(T)
    tri = idx[:, None] >= idx[None, :]
    outs = []
    for c0 in range(0, S, T):
        qc, kc, vc = (x[:, :, c0:c0 + T] for x in (qt, kt, vt))
        li = li_all[:, :, c0:c0 + T]
        b = torch.cumsum(lf_all[:, :, c0:c0 + T], dim=-1)
        intra = torch.where(tri, (b[..., :, None] - b[..., None, :])
                            + li[..., None, :], ref.NEG_INF)
        m_t = torch.maximum(b + m[..., None], intra.amax(-1))
        e = torch.exp((b + m[..., None]) - m_t)
        s = torch.where(tri, ((qc @ kc.transpose(-1, -2)) * scale)
                        * torch.exp(intra - m_t[..., None]), 0.0)
        sh, sl = _split(s, hi_lo)
        num = sh @ vc + sl @ vc
        den = s.sum(-1)
        if c0:
            ch, cl = _split(C, hi_lo)
            qC = qc @ ch.transpose(-1, -2) + qc @ cl.transpose(-1, -2)
            num = e[..., None] * (qC * scale) + num
            den = den + e * (scale * (qc @ n[..., None])[..., 0])
        den = torch.maximum(den.abs(), torch.exp(-m_t))
        outs.append(num / den[..., None])
        Fc = b[..., -1]
        m_out = torch.maximum(Fc + m, ((Fc[..., None] - b) + li).amax(-1))
        w = torch.exp(((Fc[..., None] - b) + li) - m_out[..., None])
        g = torch.exp((Fc + m) - m_out)
        wh, wl = _split(w[..., None] * vc, hi_lo)
        C = g[..., None, None] * C + (wh.transpose(-1, -2) @ kc
                                      + wl.transpose(-1, -2) @ kc)
        n = g[..., None] * n + (w[..., None] * kc).sum(-2)
        m = m_out
    return torch.cat(outs, dim=2).transpose(1, 2)


def _inputs(seed, B, S, H, D):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, D))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    ig = torch.from_numpy(rng.standard_normal((B, S, H)).astype(np.float32))
    fg = torch.from_numpy((rng.standard_normal((B, S, H)) + 3.0)
                          .astype(np.float32))
    return q, k, v, ig, fg


# (B, S, H, D, chunk): four chunks at the sweep's head dim (the state pass
# and the carried C), and xlstm_350m's head dim in one chunk of 128.
# Readings (max |model - plain| / max |plain|, float32 before the bf16
# rounding of h), hi + lo / single bf16: 3.68e-6 / 3.36e-3 and
# 4.51e-6 / 2.30e-3.  The test holds the model to 1e-5 (2.7x and 2.2x
# above the readings) and single bf16 at least 100x further from the plain
# version than hi + lo (9.1x and 5.1x beyond that); MLSTM_REL[bf16], the
# card's bound, is 8e-3.  In bf16, against the JAX package's Pallas kernel
# (interpret mode, bf16 h): 2.89e-4 and 3.40e-3 of the largest |h|,
# within MLSTM_REL[bf16] (28x and 2.4x room); the plain version's own bf16
# output lies 5.79e-4 and 1.70e-3 from it.
MODEL_CASES = [(2, 256, 2, 64, 64), (1, 128, 1, 512, 128)]
MODEL_REL = 1e-5
MLSTM_REL_BF16 = 8e-3  # chip_smoke.py:MLSTM_REL[bf16]


@pytest.mark.parametrize("B,S,H,D,chunk", MODEL_CASES)
def test_wgmma_arithmetic_model_matches_plain_and_needs_hi_lo(B, S, H, D,
                                                             chunk):
    q, k, v, ig, fg = _inputs(D + S, B, S, H, D)
    assert ml.route(q.dtype, D) == "wgmma"
    want = ref.chunkwise_mlstm(q.float(), k.float(), v.float(), ig, fg,
                               chunk=chunk)
    scale = want.abs().max().item()
    model = wgmma_model(q, k, v, ig, fg, chunk)
    single = wgmma_model(q, k, v, ig, fg, chunk, hi_lo=False)
    err = (model - want).abs().max().item() / scale
    err_single = (single - want).abs().max().item() / scale
    assert err <= MODEL_REL, err
    assert 100 * err < err_single, (err, err_single)
    # in bf16, against the JAX package's Pallas kernel in interpret mode
    jax_h = np.asarray(pl_mlstm(*(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16) for x in (q, k, v)), jnp.asarray(ig.numpy()),
        jnp.asarray(fg.numpy()), chunk=chunk, interpret=True
    ).astype(jnp.float32))
    got = model.bfloat16().float().numpy()
    assert np.abs(got - jax_h).max() <= MLSTM_REL_BF16 * np.abs(jax_h).max()
