"""The port's RG-LRU path (recurrentgemma_2b) against the JAX package, on
the CPU.

Inputs are made from a seed with numpy and handed to both packages; the
models run the weights of ``T.init_lm(jax.random.PRNGKey(0), cfg)``
(through ``tree_from_jax``).  The JAX package's Pallas RG-LRU kernel runs
in interpret mode, as its own tests run it.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.rglru import rglru as pl_rglru
from repro.models import rglru as jrglru
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.convert import to_tensor, tree_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import config as tconfig
from repro_torch.models import rglru as trglru
from repro_torch.models import transformer as TT
from repro_torch.tree import flatten

# float32, the same expression graph: exp/log/sigmoid differ by an ulp or
# so between XLA and torch, and the recurrence carries the difference on
TOL_F32 = dict(rtol=1e-5, atol=1e-6)
# tests/test_kernels.py's tolerances for the Pallas RG-LRU kernel
TOL = dict(rtol=2e-2, atol=2e-3)
TOL32 = dict(rtol=1e-4, atol=1e-5)
# float32 through 13 layers: matmul and softmax sums run in another order
# in XLA and torch, and the differences feed back through the state
TOL_MODEL = dict(rtol=2e-4, atol=2e-5)
# bfloat16 through 13 layers: XLA and torch round bf16 intermediates at
# other places (XLA widens elementwise chains to float32 and rounds once).
# On the smoke model each package's bf16 prefill logits lie 2.6-2.7 %
# (relative L2) from the float32 run's, and the two bf16 runs 3.0 % from
# each other: independent rounding, not a different function.  So the
# bound is on the relative L2 error (about 3x that), with a loose
# elementwise bound beside it (cache entries reach |x| ~ 4).
TOL_MODEL_BF16 = dict(rtol=1e-1, atol=2.5e-1, rel_l2=1e-1)


def _inputs(seed, B, S, W, dtype=np.float32, h0=False):
    rng = np.random.default_rng(seed)
    x, ga, gx = (rng.standard_normal((B, S, W)).astype(np.float32)
                 for _ in range(3))
    a = rng.standard_normal(W).astype(np.float32)
    h = rng.standard_normal((B, W)).astype(np.float32) if h0 else None
    if dtype != np.float32:  # round once, hand both packages the same bits
        x, ga, gx = (np.asarray(jnp.asarray(t, jnp.bfloat16))
                     for t in (x, ga, gx))
    return x, a, ga, gx, h


def _torch(*arrays):
    return [None if a is None else to_tensor(a, "cpu") for a in arrays]


def _jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("B,S,W", [(1, 1, 8), (2, 37, 48), (3, 64, 130)])
def test_naive_rglru_matches_jax_naive(B, S, W, h0):
    arrays = _inputs(1, B, S, W, h0=h0)
    want_seq, want_last = jref.naive_rglru(*_jax(*arrays))
    got_seq, got_last = ref.naive_rglru(*_torch(*arrays))
    assert got_seq.dtype == torch.float32 and got_last.dtype == torch.float32
    np.testing.assert_allclose(got_seq.numpy(), want_seq, **TOL_F32)
    np.testing.assert_allclose(got_last.numpy(), want_last, **TOL_F32)


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,W", [(1, 64, 128), (2, 128, 256), (1, 96, 512)])
def test_naive_rglru_matches_pallas_kernel(B, S, W, dtype, h0):
    """The plain version against the TPU kernel in interpret mode, at
    tests/test_kernels.py's shapes and tolerances."""
    arrays = _inputs(2, B, S, W, np.float32 if dtype == "float32" else
                     jnp.bfloat16, h0=h0)
    x, a, ga, gx, h = _jax(*arrays)
    want_seq, want_last = pl_rglru(x, a, ga, gx, h, block_w=128, chunk=32,
                                   interpret=True)
    got_seq, got_last = ref.naive_rglru(*_torch(*arrays))
    assert str(got_seq.dtype).removeprefix("torch.") == dtype
    tol = TOL if dtype == "bfloat16" else TOL32
    np.testing.assert_allclose(_f32(got_seq), _f32(want_seq), **tol)
    np.testing.assert_allclose(got_last.numpy(), want_last, **TOL32)


def test_naive_rglru_matches_blockwise():
    """The JAX package's CPU lowering (chunked associative form) at
    tests/test_kernels.py's tolerance for it, with h0."""
    arrays = _inputs(3, 2, 160, 48, h0=True)
    want_seq, want_last = jref.blockwise_rglru(*_jax(*arrays), block=32)
    got_seq, got_last = ref.naive_rglru(*_torch(*arrays))
    np.testing.assert_allclose(got_seq.numpy(), want_seq, rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(got_last.numpy(), want_last, rtol=1e-3,
                               atol=1e-4)


def test_ops_rglru_scan_is_plain_version_on_cpu():
    arrays = _torch(*_inputs(4, 2, 9, 16, h0=True))
    got = ops.rglru_scan(*arrays)
    want = ref.naive_rglru(*arrays)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_rglru_state_carries_across_calls():
    """Two calls, the second from the first's h_last, give the one-call
    result (the same sequence loop; the CPU's vectorised exp and sigmoid
    may round a lane of another shape an ulp apart)."""
    x, a, ga, gx, _ = _torch(*_inputs(5, 2, 40, 24))
    whole_seq, whole_last = ref.naive_rglru(x, a, ga, gx)
    s1, h1 = ref.naive_rglru(x[:, :17], a, ga[:, :17], gx[:, :17])
    s2, h2 = ref.naive_rglru(x[:, 17:], a, ga[:, 17:], gx[:, 17:], h1)
    torch.testing.assert_close(torch.cat([s1, s2], 1), whole_seq,
                               rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(h2, whole_last, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_decode_step_matches_jax(dtype):
    rng = np.random.default_rng(6)
    B, W = 3, 40
    h = rng.standard_normal((B, W)).astype(np.float32)
    x, ga, gx = (np.asarray(jnp.asarray(rng.standard_normal((B, W)),
                                        getattr(jnp, dtype)))
                 for _ in range(3))
    a = rng.standard_normal(W).astype(np.float32)
    want = jref.rglru_decode_step(*_jax(h, x, a, ga, gx))
    got = ref.rglru_decode_step(*_torch(h, x, a, ga, gx))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL_F32)
    # a decode step is a one-step scan of the plain version
    seq, last = ref.naive_rglru(*_torch(x[:, None], a, ga[:, None],
                                        gx[:, None], h))
    torch.testing.assert_close(last, got, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the block and the model
# ---------------------------------------------------------------------------

def _cfgs(dtype="float32"):
    jcfg = dataclasses.replace(jconfigs.get_smoke("recurrentgemma_2b"),
                               dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_smoke("recurrentgemma_2b"),
                               dtype=dtype)
    assert (jcfg.name, jcfg.num_layers, jcfg.window) == \
        (tcfg.name, tcfg.num_layers, tcfg.window) == ("recurrentgemma-2b",
                                                       13, 8)
    return jcfg, tcfg


def _tol(dtype):
    return TOL_MODEL if dtype == "float32" else TOL_MODEL_BF16


def _assert_close(got, want, err_msg="", *, rtol, atol, rel_l2=None):
    got, want = _f32(got), _f32(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=err_msg)
    if rel_l2 is not None:
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= rel_l2, (err_msg, err)


def _assert_trees_close(jtree, ttree, **tol):
    """Same keys, shapes and dtypes; values allclose, ``pos`` exact."""
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tleaves, _ = flatten(ttree)
    assert len(jflat) == len(tleaves)
    for (path, j), t in zip(jflat, tleaves):
        name = jax.tree_util.keystr(path)
        assert tuple(t.shape) == j.shape, name
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name, name
        if name.endswith("['pos']"):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), name)
        else:
            _assert_close(t, j, name, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_forward_and_decode_carry_state(dtype):
    """One RG-LRU block: a 12-token forward from zero state, then 3 decode
    steps and a 5-token forward from the carried {h, conv}."""
    jcfg, tcfg = _cfgs(dtype)
    jparams = jrglru.init_rglru_block(jax.random.PRNGKey(1), jcfg)
    tparams = tree_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(7)
    xs = np.asarray(jnp.asarray(rng.standard_normal((2, 20, jcfg.d_model)),
                                getattr(jnp, dtype)))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else TOL
    jy, jstate = jrglru.rglru_block_forward(jparams, jnp.asarray(xs[:, :12]),
                                            jcfg)
    ty, tstate = trglru.rglru_block_forward(tparams, to_tensor(xs[:, :12],
                                                               "cpu"), tcfg)
    np.testing.assert_allclose(_f32(ty), _f32(jy), **tol)
    _assert_trees_close(jstate, tstate, **tol)
    for t in range(12, 15):
        jy, jstate = jrglru.rglru_decode_step(
            jparams, jnp.asarray(xs[:, t:t + 1]), jcfg, jstate)
        ty, tstate = trglru.rglru_decode_step(
            tparams, to_tensor(xs[:, t:t + 1], "cpu"), tcfg, tstate)
        np.testing.assert_allclose(_f32(ty), _f32(jy), **tol)
        _assert_trees_close(jstate, tstate, **tol)
    jy, jstate = jrglru.rglru_block_forward(jparams, jnp.asarray(xs[:, 15:]),
                                            jcfg, jstate)
    ty, tstate = trglru.rglru_block_forward(tparams, to_tensor(xs[:, 15:],
                                                               "cpu"),
                                            tcfg, tstate)
    np.testing.assert_allclose(_f32(ty), _f32(jy), **tol)
    _assert_trees_close(jstate, tstate, **tol)
    assert tstate["conv"].dtype == getattr(torch, dtype)


def test_init_rglru_state_matches_jax():
    jcfg, tcfg = _cfgs()
    _assert_trees_close(jrglru.init_rglru_state(jcfg, 3),
                        trglru.init_rglru_state(tcfg, 3, device="cpu"),
                        rtol=0, atol=0)


@functools.lru_cache(maxsize=None)
def _models(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = tree_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_prefill(params, cfg, cache, tokens):
    return JT.lm_prefill(params, {"tokens": tokens}, cfg, cache)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_decode(params, cfg, cache, tokens, positions):
    return JT.lm_decode_step(params, tokens, positions, cfg, cache)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_append(params, cfg, cache, tokens, positions):
    return JT.lm_append(params, tokens, positions, cfg, cache)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_forward(params, cfg, tokens):
    return JT.lm_forward(params, {"tokens": tokens}, cfg)[0]


def test_params_and_cache_trees_identical_to_jax():
    jcfg, jparams, tcfg, tparams = _models("float32")
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tleaves, _ = flatten(tparams)
    own = flatten(TT.init_lm(tcfg, seed=0, device="cpu"))[0]
    assert len(jflat) == len(tleaves) == len(own)
    names = {jax.tree_util.keystr(p) for p, _ in jflat}
    for key in ("w_x", "w_gate_branch", "conv_w", "conv_b", "gate_a_w",
                "gate_x_w", "gate_a_b", "gate_x_b", "a_param", "w_out"):
        assert any(n.startswith(f"['groups']['b0']['rglru']['{key}']")
                   for n in names), key
    for (path, j), t, o in zip(jflat, tleaves, own):
        assert tuple(t.shape) == tuple(o.shape) == j.shape, path
        assert t.dtype == o.dtype, path
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    _assert_trees_close(JT.init_cache(jcfg, 2, 32),
                        TT.init_cache(tcfg, 2, 32, device="cpu"),
                        rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_forward_matches_jax(dtype):
    jcfg, jparams, tcfg, tparams = _models(dtype)
    toks = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    want = _jax_forward(jparams, jcfg, jnp.asarray(toks))
    got, _ = TT.lm_forward(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert got.dtype == torch.float32
    _assert_close(got, want, **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prompt", [24, 20])
def test_serving_calls_match_jax(dtype, prompt):
    """A prompt longer than the 8-slot local ring (24 takes the JAX
    package's banded attention, 20 its blockwise path), 12 decode steps
    past the window, then a 5-token append: logits and every cache leaf
    after each call."""
    jcfg, jparams, tcfg, tparams = _models(dtype)
    tol = _tol(dtype)
    B, max_seq = 2, 48
    rng = np.random.default_rng(9 + prompt)
    toks = rng.integers(0, jcfg.vocab_size, (B, prompt + 17)).astype(np.int32)
    jcache = JT.init_cache(jcfg, B, max_seq)
    tcache = TT.init_cache(tcfg, B, max_seq, device="cpu")
    jl, jcache = _jax_prefill(jparams, jcfg, jcache,
                              jnp.asarray(toks[:, :prompt]))
    tl, tcache = TT.lm_prefill(
        tparams, {"tokens": torch.from_numpy(toks[:, :prompt])}, tcfg, tcache)
    _assert_close(tl, jl, **tol)
    _assert_trees_close(jcache, tcache, **tol)
    for t in range(prompt, prompt + 12):
        pos = np.full((B, 1), t, np.int32)
        tok = toks[:, t:t + 1]
        jl, jcache = _jax_decode(jparams, jcfg, jcache, jnp.asarray(tok),
                                 jnp.asarray(pos))
        tl, tcache = TT.lm_decode_step(tparams, torch.from_numpy(tok),
                                       torch.from_numpy(pos), tcfg, tcache)
        _assert_close(tl, jl, **tol)
    _assert_trees_close(jcache, tcache, **tol)
    pos = np.broadcast_to(np.arange(prompt + 12, prompt + 17, dtype=np.int32),
                          (B, 5)).copy()
    jl, jcache = _jax_append(jparams, jcfg, jcache,
                             jnp.asarray(toks[:, prompt + 12:]),
                             jnp.asarray(pos))
    tl, tcache = TT.lm_append(tparams, torch.from_numpy(toks[:, prompt + 12:]),
                              torch.from_numpy(pos), tcfg, tcache)
    _assert_close(tl, jl, **tol)
    _assert_trees_close(jcache, tcache, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_from_jax_continues_in_the_port(dtype):
    """The JAX package's cache after a prefill, carried across by
    ``tree_from_jax`` (bf16 ``conv`` and KV leaves included), decodes in
    the port as it does in the JAX package."""
    jcfg, jparams, tcfg, tparams = _models(dtype)
    B = 2
    toks = np.random.default_rng(10).integers(
        0, jcfg.vocab_size, (B, 18)).astype(np.int32)
    _, jcache = _jax_prefill(jparams, jcfg, JT.init_cache(jcfg, B, 32),
                             jnp.asarray(toks[:, :14]))
    tcache = tree_from_jax(jax.tree.map(np.asarray, jcache), "cpu")
    _assert_trees_close(jcache, tcache, rtol=0, atol=0)
    for t in range(14, 18):
        pos = np.full((B, 1), t, np.int32)
        jl, jcache = _jax_decode(jparams, jcfg, jcache,
                                 jnp.asarray(toks[:, t:t + 1]),
                                 jnp.asarray(pos))
        tl, tcache = TT.lm_decode_step(
            tparams, torch.from_numpy(toks[:, t:t + 1]),
            torch.from_numpy(pos), tcfg, tcache)
        _assert_close(tl, jl, **_tol(dtype))
    _assert_trees_close(jcache, tcache, **_tol(dtype))


def test_recurrentgemma_config_matches_jax():
    for get in ("get_config", "get_smoke"):
        j = getattr(jconfigs, get)("recurrentgemma_2b")
        t = getattr(tconfigs, get)("recurrentgemma_2b")
        for f in dataclasses.fields(tconfig.ModelConfig):
            a, b = getattr(j, f.name), getattr(t, f.name)
            if f.name == "pattern":
                a = tuple((m.value, n.value) for m, n in a)
                b = tuple((m.value, n.value) for m, n in b)
            assert a == b, f.name
    assert t.param_count() == j.param_count()
