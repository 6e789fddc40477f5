"""The port's fused codec path against the JAX package's, on the CPU.

The same inputs, made from a seed with numpy, go through both packages:

  * kernel level: ``repro_torch.kernels.codec``'s plain versions (what a
    CPU tensor runs, and what the CUDA kernels are held to on a card)
    against ``repro.kernels.codec``'s Pallas kernels in interpret mode
    and their jnp versions: fingerprint lanes, XOR words, ``q`` and
    ``scale`` bit for bit, edge values included;
  * quantizer: ``optim.compression`` (``_quant``, ``_dequant``,
    ``compress_gradients``) bit for bit;
  * codec level: ``xor_rle``/``int8`` blobs byte for byte, decodes,
    ``FusedLeafEncoding`` blobs and ``resolve_compression``.

Every comparison is exact: no tolerance.
"""
import itertools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import codecs as jcodecs
from repro.kernels import codec as jck
from repro.kernels import ops as jops
from repro.optim import compression as jcomp
from repro_torch.checkpoint import codecs as tcodecs
from repro_torch.checkpoint.fingerprint import leaf_fingerprints
from repro_torch.kernels import codec as tck
from repro_torch.kernels import ops as tops
from repro_torch.optim import compression as tcomp

CB = 2048  # the small 512-aligned chunk grid of tests/test_codec_kernels.py

# element counts straddling the word grid (512 B), the quant-block grid
# (256 floats = 2 word rows) and the chunk grid
SIZES = [CB // 4, 3 * CB // 4 + 7, 100, 129, 384, 5 * CB // 4,
         2 * (CB // 4) + 1]


def _pair(n, seed=0, kind="stripes", dtype=np.float32):
    rng = np.random.default_rng(seed)
    cur = rng.standard_normal(n).astype(dtype)
    if kind == "clean":
        parent = cur.copy()
    elif kind == "dense":
        parent = rng.standard_normal(n).astype(dtype)
    else:
        parent = cur.copy()
        idx = rng.integers(0, n, size=max(1, n // 50))
        parent[idx] += rng.standard_normal(idx.size).astype(dtype)
    return cur, parent


def _t(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor (bfloat16 through its bits)."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x) -> np.ndarray:
    """Any 32-bit array (jax, torch or numpy) as uint32 bits."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x).view(np.uint32)


# ---------------------------------------------------------------------------
# kernel level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["stripes", "dense", "clean"])
def test_xor_fp_plain_matches_jax(n, kind):
    cur, parent = _pair(n, seed=n, kind=kind)
    jw, jp = jops._codec_words(jnp.asarray(cur), parent.tobytes(), CB,
                               pair=False)
    tw, tp = tops._codec_words(_t(cur), parent.tobytes(), CB)
    lanes, xor = tck.xor_fp_ref(tw, tp)
    for j_lanes, j_xor in (jck.xor_fp_ref(jw, jp),
                           jck.xor_fp_lanes(jw, jp, interpret=True)):
        assert np.array_equal(_bits(lanes), _bits(j_lanes))
        assert np.array_equal(_bits(xor), _bits(j_xor))
    fps, _ = tops.fused_xor_fingerprint(_t(cur), parent.tobytes(), CB)
    jfps, _ = jops.fused_xor_fingerprint(jnp.asarray(cur), parent.tobytes(),
                                         CB)
    assert np.array_equal(fps.numpy().astype(np.uint32), np.asarray(jfps))
    assert np.array_equal(fps.numpy().astype(np.uint32),
                          leaf_fingerprints(_t(cur), CB))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["stripes", "dense", "clean"])
def test_int8_fp_plain_matches_jax(n, kind):
    cur, parent = _pair(n, seed=n + 1, kind=kind)
    jw, jp = jops._codec_words(jnp.asarray(cur), parent.tobytes(), CB,
                               pair=True)
    tw, tp = tops._codec_words(_t(cur), parent.tobytes(), CB)
    lanes, q, scale = tck.int8_fp_ref(tw, tp)
    assert q.dtype == torch.int8
    for j_lanes, j_q, j_scale in (jck.int8_fp_ref(jw, jp),
                                  jck.int8_fp_lanes(jw, jp, interpret=True)):
        assert np.array_equal(_bits(lanes), _bits(j_lanes))
        assert np.array_equal(q.numpy(), np.asarray(j_q).astype(np.int8))
        assert np.array_equal(_bits(scale), _bits(j_scale))
    fps, _, _ = tops.fused_int8_fingerprint(_t(cur), parent.tobytes(), CB)
    assert np.array_equal(fps.numpy().astype(np.uint32),
                          leaf_fingerprints(_t(cur), CB))


@pytest.mark.parametrize("C,R", [(1, 3), (3, 5), (2, 1), (1, 8)])
def test_int8_fp_odd_rows_padded_as_pair_rows(C, R):
    """Odd row counts per chunk: the port pads as ``pair_rows`` does."""
    rng = np.random.default_rng(C * 10 + R)
    cur = rng.standard_normal((C, R, 128)).astype(np.float32)
    par = cur + rng.standard_normal(cur.shape).astype(np.float32) * (
        rng.random(cur.shape) < 0.1)
    got = tck.int8_fp_ref(_t(cur.view(np.int32)), _t(par.view(np.int32)))
    jc = jck.pair_rows(jnp.asarray(cur.view(np.uint32)))
    jp = jck.pair_rows(jnp.asarray(par.view(np.uint32)))
    want = jck.int8_fp_lanes(jc, jp, interpret=True)
    assert got[1].shape == (C, -(-R // 2), 256)
    assert np.array_equal(_bits(got[0]), _bits(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]).astype(np.int8))
    assert np.array_equal(_bits(got[2]), _bits(want[2]))
    assert torch.equal(tck.pair_rows(_t(cur.view(np.int32))).view(
        torch.float32)[:, :R], _t(cur))


def test_int8_edge_values_bit_identical():
    cur, par = tck.edge_blocks()
    cw = cur.view(np.uint32).reshape(1, -1, 128)
    pw = par.view(np.uint32).reshape(1, -1, 128)
    got = tck.int8_fp_ref(_t(cw.view(np.int32)), _t(pw.view(np.int32)))
    for want in (jck.int8_fp_ref(jnp.asarray(cw), jnp.asarray(pw)),
                 jck.int8_fp_lanes(jnp.asarray(cw), jnp.asarray(pw),
                                   interpret=True)):
        assert np.array_equal(got[1].numpy(),
                              np.asarray(want[1]).astype(np.int8))
        assert np.array_equal(_bits(got[2]), _bits(want[2]))
    scale = got[2].numpy()[0]
    assert np.isnan(scale[3]) and np.isinf(scale[4])
    assert scale[1] == np.float32(1e-12)
    assert np.all(got[1].numpy()[0, 3] == 0)  # a NaN block quantizes to 0
    # the host quantizer (the int8 codec's) agrees with both
    d = cur - par
    tq, ts, _, _ = tcomp._quant(torch.from_numpy(d))
    jq, js, _, _ = jcomp._quant(jnp.asarray(d))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(_bits(ts), _bits(js))
    assert np.array_equal(tq.numpy(), got[1].numpy()[0])


# ---------------------------------------------------------------------------
# optim/compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(256,), (3, 100), (7,), (2, 3, 129)])
def test_quant_dequant_identical(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 10 ** rng.uniform(-3, 3)).astype(
        np.float32)
    tq, ts, tshape, tpad = tcomp._quant(torch.from_numpy(x))
    jq, js, jshape, jpad = jcomp._quant(jnp.asarray(x))
    assert tq.dtype == torch.int8 and (tshape, tpad) == (jshape, jpad)
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(_bits(ts), _bits(js))
    td = tcomp._dequant(tq, ts, tshape, tpad)
    jd = jcomp._dequant(jq, js, jshape, jpad)
    assert np.array_equal(_bits(td), _bits(jd))


def test_compress_gradients_identical():
    rng = np.random.default_rng(3)
    grads = {"w": rng.standard_normal((4, 300)).astype(np.float32),
             "b": [rng.standard_normal(9).astype(np.float32),
                   rng.standard_normal((2, 2)).astype(np.float32)]}
    tg = jax.tree.map(torch.from_numpy, grads)
    jg = jax.tree.map(jnp.asarray, grads)
    te, je = tcomp.ef_init(tg), jcomp.ef_init(jg)
    for _ in range(3):  # error feedback carries over steps
        tc, te = tcomp.compress_gradients(tg, te)
        jc, je = jcomp.compress_gradients(jg, je)
        for a, b in zip(jax.tree.leaves(te), jax.tree.leaves(je)):
            assert np.array_equal(_bits(a), _bits(b))
        for key in ("q", "scale"):
            for a, b in zip(jax.tree.leaves(jax.tree.map(
                    lambda c: c[key], tc, is_leaf=lambda c: "q" in c)),
                            jax.tree.leaves(jax.tree.map(
                    lambda c: c[key], jc, is_leaf=lambda c: "q" in c))):
                assert np.array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8))
        td = tcomp.decompress_gradients(tc, tg)
        jd = jcomp.decompress_gradients(jc, jg)
        for a, b in zip(jax.tree.leaves(td), jax.tree.leaves(jd)):
            assert np.array_equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# codec level
# ---------------------------------------------------------------------------

DTYPES = [np.float32, ml_dtypes.bfloat16, np.float64, np.int32, np.uint8]


def _dtype_pair(dtype, n, seed, kind):
    if np.dtype(dtype).kind in "iu":
        rng = np.random.default_rng(seed)
        cur = rng.integers(0, 100, n).astype(dtype)
        parent = cur.copy()
        if kind == "dense":
            parent = rng.integers(0, 100, n).astype(dtype)
        elif kind == "stripes":
            parent[rng.integers(0, n, max(1, n // 50))] += 1
        return cur, parent
    cur, parent = _pair(n, seed, kind)
    return cur.astype(dtype), parent.astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("kind", ["stripes", "dense", "clean"])
def test_codec_blobs_byte_identical(dtype, kind):
    codecs = ["xor_rle"] + (["int8"] if np.dtype(dtype).kind == "f" else [])
    for n in (CB // np.dtype(dtype).itemsize, 1001):
        cur, parent = _dtype_pair(dtype, n, n, kind)
        raw, praw = cur.tobytes(), parent.tobytes()
        dt = np.dtype(dtype)
        for name in codecs:
            blob = tcodecs.get_codec(name).encode(raw, praw, dt)
            assert blob == jcodecs.get_codec(name).encode(raw, praw, dt)
            back = tcodecs.get_codec(name).decode(blob, praw, dt)
            assert back == jcodecs.get_codec(name).decode(blob, praw, dt)
            if name == "xor_rle":
                assert back == raw


def test_codec_blobs_byte_identical_on_edge_values():
    cur, par = tck.edge_blocks()
    raw, praw = cur.tobytes(), par.tobytes()
    dt = np.dtype(np.float32)
    for name in ("xor_rle", "int8"):
        blob = tcodecs.get_codec(name).encode(raw, praw, dt)
        assert blob == jcodecs.get_codec(name).encode(raw, praw, dt)
        assert (tcodecs.get_codec(name).decode(blob, praw, dt)
                == jcodecs.get_codec(name).decode(blob, praw, dt))


@pytest.mark.parametrize("codec", ["xor_rle", "int8"])
@pytest.mark.parametrize("n", SIZES)
def test_fused_leaf_encoding_blobs_equal_host_codec(codec, n):
    cur, parent = _pair(n, seed=3 * n, kind="stripes")
    if n == 129:
        cur, parent = tck.edge_blocks()  # NaN and inf through the fused path
    dt = np.dtype(np.float32)
    enc = tcodecs.FusedLeafEncoding(_t(cur), parent.tobytes(), codec, dt, CB)
    jenc = jcodecs.FusedLeafEncoding(jnp.asarray(cur), parent.tobytes(),
                                     codec, dt, CB)
    assert np.array_equal(enc.fps, np.asarray(jenc.fps))
    assert np.array_equal(enc.fps, leaf_fingerprints(_t(cur), CB))
    raw, praw = cur.tobytes(), parent.tobytes()
    for c in range(-(-len(raw) // CB)):
        seg, pseg = raw[c * CB:(c + 1) * CB], praw[c * CB:(c + 1) * CB]
        blob = enc.blob(c)
        assert blob == tcodecs.get_codec(codec).encode(seg, pseg, dt)
        assert blob == jenc.blob(c)
        assert enc.raw_seg(c) == seg


SPECS = ["none", "xor_rle", "int8", "auto", "zstd",
         {"state": "int8"}, {"other": "int8"}, {"state": "bogus"}]


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_resolve_compression_agrees_on_the_grid(spec):
    for dtype, parent, lossy, cb in itertools.product(
            [np.float32, ml_dtypes.bfloat16, np.float64, np.int32, np.uint8,
             np.bool_], [False, True], [False, True], [0, 6, 4096, 4098]):
        args = ("state", np.dtype(dtype), parent, lossy)
        try:
            want = jcodecs.resolve_compression(spec, *args, chunk_bytes=cb)
        except ValueError:
            with pytest.raises(ValueError):
                tcodecs.resolve_compression(spec, *args, chunk_bytes=cb)
            continue
        assert tcodecs.resolve_compression(spec, *args,
                                           chunk_bytes=cb) == want
