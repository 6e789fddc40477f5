"""The port's kernel functions against the JAX package, on the CPU.

On the CPU the port's entry points run each kernel's plain PyTorch
version; the CUDA kernels themselves are held to those plain versions on
the card (tests/test_torch_gpu.py, chip_smoke.py).  Inputs are numpy,
made from seeds, and go to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fingerprint as jfp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import fingerprint as tfp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# float32: reduction order differs between XLA and torch's CPU einsum
TOL32 = dict(rtol=1e-4, atol=1e-5)
# bfloat16 inputs and output: a few bf16 ulps of an O(1) result
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)
CHUNK = 4 * 1024


def _decode_inputs(seed, B, S, H, Hkv, D, ring):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D), np.float32)
    k = rng.standard_normal((B, S, Hkv, D), np.float32)
    v = rng.standard_normal((B, S, Hkv, D), np.float32)
    if ring:
        # a local layer's ring buffer: empty slots, slots ahead of the
        # query, the rest valid in no order; the current slot is written
        qpos = rng.integers(S // 2, 2 * S, B).astype(np.int32)
        kpos = rng.integers(-1, 2 * S, (B, S)).astype(np.int32)
        kpos[:, 0] = qpos
    else:  # the test_kernels.py decode case
        qpos = np.array([S // 2, S - 1][:B], np.int32)
        kpos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        kpos = np.where(kpos <= qpos[:, None], kpos, -1).astype(np.int32)
    return q, k, v, qpos, kpos


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("B,S,H,Hkv,D", [(2, 256, 8, 2, 64), (1, 128, 4, 4, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_jax(B, S, H, Hkv, D, dtype, ring):
    q, k, v, qpos, kpos = _decode_inputs(B * S + ring, B, S, H, Hkv, D, ring)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jref.decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        q_pos=jnp.asarray(qpos), k_pos=jnp.asarray(kpos))
    got = tops.decode_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), torch.from_numpy(qpos),
        torch.from_numpy(kpos))
    assert got.dtype == tdt and got.shape == (B, 1, H, D)
    tol = TOL32 if dtype == "float32" else TOL_BF16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_chunk_attention_plain_matches_jax():
    rng = np.random.default_rng(7)
    B, K, S, H, Hkv, D = 2, 8, 64, 4, 2, 16
    q = rng.standard_normal((B, K, H, D), np.float32)
    k = rng.standard_normal((B, S, Hkv, D), np.float32)
    v = rng.standard_normal((B, S, Hkv, D), np.float32)
    qpos = np.stack([np.arange(20, 20 + K)] * B).astype(np.int32)
    kpos = np.where(np.arange(S) < 28, np.arange(S), -1)
    kpos = np.stack([kpos] * B).astype(np.int32)
    for window in (0, 6):
        want = jref.chunk_attention(q, k, v, q_pos=qpos, k_pos=kpos,
                                    window=window)
        got = tref.chunk_attention(*map(torch.from_numpy, (q, k, v)),
                                   q_pos=torch.from_numpy(qpos),
                                   k_pos=torch.from_numpy(kpos),
                                   window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise; only ops picks the plain path."""
    q, k, v, qpos, kpos = map(torch.from_numpy,
                              _decode_inputs(0, 1, 64, 4, 2, 16, False))
    with pytest.raises(ValueError, match="CUDA"):
        tda.decode_attention(q, k, v, qpos, kpos)
    with pytest.raises(ValueError, match="CUDA"):
        tfp.fingerprint_lanes(torch.zeros((1, 4, 128), dtype=torch.int32))
    assert tda.LAUNCHES == 0 and tfp.LAUNCHES == 0


@pytest.mark.parametrize("S", [32, 100, 2048, 5000])
def test_decode_split_plan_covers_the_cache(S):
    """The decode kernel's cluster: its CTAs' runs of keys cover the cache,
    none of them empty, within the portable cluster size."""
    plan = tda.decode_plan(1, S, 4, 2, 32, 4)
    per_cta = tda.WARPS * plan.keys_per_warp
    assert 1 <= plan.cluster <= tda.MAX_CLUSTER
    assert (plan.cluster - 1) * per_cta < S <= plan.cluster * per_cta


@pytest.mark.parametrize("C,R", [(1, 1), (1, 8192), (3, 77)])
def test_fingerprint_lanes_plain_matches_jax(C, R):
    rng = np.random.default_rng(C * R)
    words = rng.integers(0, 2 ** 32, (C, R, 128), dtype=np.uint64)
    words = words.astype(np.uint32)
    want = np.asarray(jfp.fingerprint_lanes_ref(jnp.asarray(words)))
    got = tfp.fingerprint_lanes_ref(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    want_fp = np.asarray(jfp.collapse_lanes(jnp.asarray(want)))
    got_fp = tfp.collapse_lanes(got).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got_fp, want_fp)


def _leaf(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "f32":
        return rng.standard_normal((4, 1, 64, 4, 8)).astype(np.float32)
    if kind == "f32-multichunk":
        return rng.standard_normal(3 * CHUNK // 4 + 5).astype(np.float32)
    if kind == "bf16":
        return rng.standard_normal((7, 13)).astype(np.float32)
    if kind == "bool":
        return rng.random(1031) > 0.5
    if kind == "i32-odd":
        return rng.integers(-5, 5, 333).astype(np.int32)
    if kind == "i64-scalar":
        return np.int64(-(2 ** 40) - 3)
    if kind == "i64-numpy":
        return rng.integers(-2 ** 62, 2 ** 62, 1500)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["f32", "f32-multichunk", "bf16", "bool",
                                  "i32-odd", "i64-scalar", "i64-numpy"])
def test_chunk_fingerprint_bit_identical_to_jax(kind):
    x = _leaf(kind, 11)
    if kind.startswith("i64"):
        # numpy leaves take the host byte view in both packages
        jx, tx = x, x
    elif kind == "bf16":
        jx = jnp.asarray(x, jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(np.asarray(x))
    want = np.asarray(jops.chunk_fingerprint(jx, CHUNK))
    got = tops.chunk_fingerprint(tx, CHUNK)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    words = tfp.chunked_words(tx, CHUNK)
    assert tuple(words.shape) == tuple(jfp.chunked_words(jx, CHUNK).shape)
