"""The port's train/prefill attention against the JAX package, on the CPU.

On the CPU ``ops.attention`` runs ``ref.naive_attention``, the plain
version the CUDA flash kernel is held to on the card.  Inputs are made
with numpy from a seed and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pl_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

TOL32 = dict(rtol=1e-5, atol=1e-5)   # float32: sum order differs
TOL_BF16 = dict(rtol=2e-2, atol=2e-3)  # output rounded to bf16 (test_kernels)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)  # float32 gradients


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: torch's intra-op threads cost more than
    they save, and beside other test processes they oversubscribe the
    cores (the suite runs files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, B, Sq, Sk, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D), np.float32),
            rng.standard_normal((B, Sk, Hkv, D), np.float32),
            rng.standard_normal((B, Sk, Hkv, D), np.float32))


def _both(arrays, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    j = [jnp.asarray(a).astype(jdt) for a in arrays]
    t = [torch.from_numpy(a).to(tdt) for a in arrays]
    return j, t


def _f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


@pytest.mark.parametrize("B,S,H,Hkv,D,window", [
    (1, 128, 2, 1, 32, 0),
    (2, 128, 4, 2, 16, 48),
])
def test_plain_matches_pallas_interpret(B, S, H, Hkv, D, window):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(0, B, S, S, H, Hkv, D), "float32")
    want = pl_flash(jq, jk, jv, causal=True, window=window, block_q=64,
                    block_k=64, interpret=True)
    got = tref.naive_attention(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL32)


# the sweep of tests/test_kernels.py::test_flash_attention_kernel
@pytest.mark.parametrize("B,S,H,Hkv,D", [
    (1, 128, 4, 4, 64),    # MHA
    (2, 256, 8, 2, 64),    # GQA 4:1
    (1, 256, 4, 1, 128),   # MQA
    (2, 128, 6, 3, 32),    # odd ratios
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 64])
def test_plain_matches_naive_sweep(B, S, H, Hkv, D, dtype, window):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, B, S, S, H, Hkv, D), dtype)
    want = jref.naive_attention(jq, jk, jv, causal=True, window=window)
    got = ops.attention(tq, tk, tv, causal=True, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = TOL_BF16 if dtype == "bfloat16" else TOL32
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (96, 96, True, 0),
    (100, 100, True, 40),   # ragged; band edges inside 64-key tiles
    (64, 64, False, 0),     # no mask (an encoder's self-attention)
    (128, 48, True, 16),    # rows past Sk + window have no valid key
])
def test_plain_masks_match_naive(Sq, Sk, causal, window):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 2, Sq, Sk, 6, 2, 32),
                                       "float32")
    want = jref.naive_attention(jq, jk, jv, causal=causal, window=window)
    got = tref.naive_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL32)


@pytest.mark.parametrize("window", [0, 24])
def test_plain_gradients_match_jax_grad(window):
    arrays = _qkv(3, 2, 80, 80, 4, 2, 32)
    w = np.random.default_rng(4).standard_normal((2, 80, 4, 32), np.float32)

    def jloss(q, k, v):
        o = jref.naive_attention(q, k, v, causal=True, window=window)
        return jnp.sum(o * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in arrays)
    out = ops.attention(tq, tk, tv, causal=True, window=window)
    (out * torch.from_numpy(w)).sum().backward()
    for t, j in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **GRAD_TOL)


def test_cpu_tensors_take_the_plain_version():
    _, (tq, tk, tv) = _both(_qkv(5, 1, 64, 64, 4, 2, 32), "float32")
    before = fa.LAUNCHES
    got = ops.attention(tq, tk, tv, causal=True, window=0)
    assert torch.equal(got, tref.naive_attention(tq, tk, tv))
    assert fa.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(tq, tk, tv)


def test_attn_scale_is_float32_rounding():
    for D in (16, 20, 32, 48, 64, 128):
        want = float(np.float32(1.0) / np.sqrt(np.float32(D)))
        assert tref.attn_scale(D) == want
        # the TPU kernel's double-rounded scale is at most one ulp away
        assert abs(np.float32(1.0 / D ** 0.5) - np.float32(want)) <= \
            np.spacing(np.float32(want))
