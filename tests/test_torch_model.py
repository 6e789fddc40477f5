"""The port's paper-consumer model against the JAX package, on the CPU.

Both packages run the weights of ``T.init_lm(jax.random.PRNGKey(0), cfg)``
(handed to the port through ``tree_from_jax``) on the same tokens.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.convert import tree_from_jax
from repro_torch.models import transformer as TT
from repro_torch.tree import flatten

# float32 through 2-4 layers: matmul and softmax sums run in another order
# in XLA and torch, and the differences feed back through the cache
TOL = dict(rtol=2e-4, atol=2e-5)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_decode(params, cfg, cache, tokens, positions):
    return JT.lm_decode_step(params, tokens, positions, cfg, cache)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_append(params, cfg, cache, tokens, positions):
    return JT.lm_append(params, tokens, positions, cfg, cache)


def _both(which):
    jcfg = (jconfigs.get_smoke if which == "smoke" else jconfigs.get_config)(
        "paper_consumer")
    tcfg = (tconfigs.get_smoke if which == "smoke" else tconfigs.get_config)(
        "paper_consumer")
    assert jcfg.name == tcfg.name and jcfg.num_layers == tcfg.num_layers
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = tree_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _assert_cache_close(jcache, tcache, **tol):
    jleaves, _ = jax.tree_util.tree_flatten(jcache)
    tleaves, _ = flatten(tcache)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_params_from_jax_keeps_keys_shapes_dtypes(which):
    jcfg, jparams, tcfg, tparams = _both(which)
    jvals = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tleaves, _ = flatten(tparams)
    assert len(jvals) == len(tleaves)
    for (path, j), t in zip(jvals, tleaves):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name, path
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # the port's own init builds the same tree
    own = TT.init_lm(tcfg, seed=0, device="cpu")
    assert [tuple(x.shape) for x in flatten(own)[0]] == \
        [tuple(x.shape) for x in tleaves]


@pytest.mark.parametrize("which,max_seq", [("smoke", 64), ("full", 96)])
def test_cache_tree_identical_to_jax(which, max_seq):
    jcfg, _, tcfg, _ = _both(which)
    jcache = JT.init_cache(jcfg, 1, max_seq)
    tcache = TT.init_cache(tcfg, 1, max_seq, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    tflat, _ = flatten(tcache)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == \
        ["['b0']['k']", "['b0']['pos']", "['b0']['v']"]
    for (path, j), t in zip(jflat, tflat):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name, path
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("which,max_seq,steps", [("smoke", 48, 70),
                                                 ("full", 96, 64)])
def test_decode_steps_match_jax(which, max_seq, steps):
    """>= 64 decode steps; with max_seq < steps the positions wrap the
    cache as the consumer's ``pos % max_seq`` does."""
    jcfg, jparams, tcfg, tparams = _both(which)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, steps).astype(np.int32)
    jcache = JT.init_cache(jcfg, 1, max_seq)
    tcache = TT.init_cache(tcfg, 1, max_seq, device="cpu")
    for i, tok in enumerate(tokens):
        pos = np.array([[i % max_seq]], np.int32)
        tok2 = np.array([[tok]], np.int32)
        jl, jcache = _jax_decode(jparams, jcfg, jcache, jnp.asarray(tok2),
                                 jnp.asarray(pos))
        tl, tcache = TT.lm_decode_step(tparams, torch.from_numpy(tok2),
                                       torch.from_numpy(pos), tcfg, tcache)
        assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(jcache, tcache, **TOL)


def test_lm_append_matches_jax():
    jcfg, jparams, tcfg, tparams = _both("smoke")
    rng = np.random.default_rng(4)
    max_seq = 64
    jcache = JT.init_cache(jcfg, 1, max_seq)
    tcache = TT.init_cache(tcfg, 1, max_seq, device="cpu")
    for i, tok in enumerate(rng.integers(0, jcfg.vocab_size, 5)):
        t = np.array([[tok]], np.int32)
        p = np.array([[i]], np.int32)
        _, jcache = _jax_decode(jparams, jcfg, jcache, jnp.asarray(t),
                                jnp.asarray(p))
        TT.lm_decode_step(tparams, torch.from_numpy(t), torch.from_numpy(p),
                          tcfg, tcache)
    toks = rng.integers(0, jcfg.vocab_size, (1, 16)).astype(np.int32)
    pos = (5 + np.arange(16, dtype=np.int32))[None]
    jl, jcache = _jax_append(jparams, jcfg, jcache, jnp.asarray(toks),
                             jnp.asarray(pos))
    tl, tcache = TT.lm_append(tparams, torch.from_numpy(toks),
                              torch.from_numpy(pos), tcfg, tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(jcache, tcache, **TOL)
