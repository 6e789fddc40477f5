"""The port's dense family (codeqwen1_5_7b: MHA; gemma3_4b: 5:1 local and
global attention with QK-norm, two RoPE thetas and a logits softcap;
chatglm3_6b: partial RoPE over 2 kv heads) against the JAX package, on
the CPU, and ``init_lm``'s stacked leaves against stacking drawn blocks.

Inputs are made from a seed with numpy and handed to both packages; the
models run the weights of ``T.init_lm(jax.random.PRNGKey(0), cfg)``
(through ``tree_from_jax``) at each config's smoke size.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.convert import tree_from_jax
from repro_torch.models import common as tcommon
from repro_torch.models import config as tconfig
from repro_torch.models import transformer as TT
from repro_torch.tree import flatten

DENSE = ("codeqwen1_5_7b", "gemma3_4b", "chatglm3_6b")
# float32 through the smoke models: matmul and softmax sums run in
# another order in XLA and torch.  Measured on the CPU: logits and cache
# leaves at most 1.3e-6 apart (relative L2; 5.5e-6 elementwise)
TOL_MODEL = dict(rtol=1e-4, atol=1e-5, rel_l2=1e-5)
# bfloat16: XLA and torch round bf16 intermediates at other places (XLA
# widens elementwise chains to float32 and rounds once).  Measured: 1.2 %
# (relative L2) for codeqwen's and chatglm3's logits, 2.6 % over gemma3's
# 17 layers; the bound is on the relative L2 error, with a loose
# elementwise bound beside it (cache entries reach |x| ~ 4)
TOL_MODEL_BF16 = dict(rtol=1e-1, atol=2.5e-1, rel_l2=5e-2)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _tol(dtype):
    return TOL_MODEL if dtype == "float32" else TOL_MODEL_BF16


def _assert_close(got, want, err_msg="", *, rtol, atol, rel_l2):
    got, want = _f32(got), _f32(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=err_msg)
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


def _cfgs(arch, dtype="float32"):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype=dtype)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _models(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
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


@pytest.mark.parametrize("arch", DENSE)
def test_config_matches_jax(arch):
    for get in ("get_config", "get_smoke"):
        j = getattr(jconfigs, get)(arch)
        t = getattr(tconfigs, get)(arch)
        for f in dataclasses.fields(tconfig.ModelConfig):
            a, b = getattr(j, f.name), getattr(t, f.name)
            if f.name == "pattern":
                a = tuple((m.value, n.value) for m, n in a)
                b = tuple((m.value, n.value) for m, n in b)
            assert a == b, (get, f.name)
        assert t.param_count() == j.param_count()


@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.25])
@pytest.mark.parametrize("local", [False, True])
def test_rope_for_matches_jax(local, fraction):
    """``rope_for`` under chatglm3's ``partial`` kind (and gemma3's local
    theta) against the reference's: the first ``fraction`` of each head
    rotated, the rest passed through unchanged."""
    jcfg, tcfg = (dataclasses.replace(c, rope_fraction=fraction,
                                      rope_theta_local=10_000.0)
                  for c in _cfgs("chatglm3_6b"))
    assert jcfg.rope_kind == tcfg.rope_kind == "partial"
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    want = jcommon.rope_for(jcfg, jnp.asarray(x), jnp.asarray(pos), local)
    got = tcommon.rope_for(tcfg, torch.from_numpy(x), torch.from_numpy(pos),
                           local)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    rot = int(16 * fraction)
    np.testing.assert_array_equal(got.numpy()[..., rot:], x[..., rot:])


@pytest.mark.parametrize("arch", DENSE)
def test_params_and_cache_trees_identical_to_jax(arch):
    jcfg, jparams, tcfg, tparams = _models(arch, "float32")
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tleaves, _ = flatten(tparams)
    own = flatten(TT.init_lm(tcfg, seed=0, device="cpu"))[0]
    assert len(jflat) == len(tleaves) == len(own)
    for (path, j), t, o in zip(jflat, tleaves, own):
        assert tuple(t.shape) == tuple(o.shape) == j.shape, path
        assert t.dtype == o.dtype, path
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for max_seq in (32, 5):
        _assert_trees_close(JT.init_cache(jcfg, 2, max_seq),
                            TT.init_cache(tcfg, 2, max_seq, device="cpu"),
                            rtol=0, atol=0, rel_l2=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_lm_forward_matches_jax(arch, dtype):
    jcfg, jparams, tcfg, tparams = _models(arch, dtype)
    toks = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    want = _jax_forward(jparams, jcfg, jnp.asarray(toks))
    got, _ = TT.lm_forward(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert got.dtype == torch.float32
    _assert_close(got, want, **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prompt", [24, 20])
@pytest.mark.parametrize("arch", DENSE)
def test_serving_calls_match_jax(arch, prompt, dtype):
    """A prefill (longer than gemma3's 8-slot local ring: 24 takes the JAX
    package's banded attention, 20 its blockwise path), 12 decode steps
    (past the window) and a 5-token append: logits and every cache leaf
    after each call."""
    jcfg, jparams, tcfg, tparams = _models(arch, dtype)
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


def test_gemma3_ring_rolls_past_the_window():
    """gemma3's local layers keep ``window`` slots and its global layers
    the whole horizon; after a 20-token prefill a local ring holds
    positions 12..19 at slot p % 8, a global cache 0..19 in order."""
    _, _, tcfg, tparams = _models("gemma3_4b", "float32")
    cache = TT.init_cache(tcfg, 1, 48, device="cpu")
    toks = torch.zeros((1, 20), dtype=torch.int32)
    TT.lm_prefill(tparams, {"tokens": toks}, tcfg, cache)
    local = [i for i, (m, _) in enumerate(tcfg.pattern)
             if m == tconfig.BlockKind.ATTN_LOCAL]
    glob = [i for i, (m, _) in enumerate(tcfg.pattern)
            if m == tconfig.BlockKind.ATTN_GLOBAL]
    assert len(local) == 15 and len(glob) == 2
    ring = cache[f"b{local[0]}"]["pos"][0, 0].tolist()
    assert ring == [16, 17, 18, 19, 12, 13, 14, 15]
    full = cache[f"b{glob[0]}"]["pos"][0, 0].tolist()
    assert full == list(range(20)) + [-1] * 28


# ---------------------------------------------------------------------------
# init_lm: stacked leaves filled row by row, block by block on threads
# ---------------------------------------------------------------------------

def _stacked_init(cfg, seed):
    """The tree ``init_lm`` builds by filling stacked leaves in place, built
    the other way: every group's block drawn on its own into fresh
    tensors (``common.materialize`` under the block's path and group
    row), then stacked (``torch.stack``)."""
    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    def draw(tree, path, row=None):
        return tcommon.materialize(tree, seed, path, row)

    def groups(path, G, cross):
        return {f"b{i}": stack([draw(TT._init_block(cfg, mixer, ffn, cross),
                                     f"{path}/b{i}", g) for g in range(G)])
                for i, (mixer, ffn) in enumerate(cfg.pattern)}

    d = cfg.d_model
    params = {
        "embed": draw(tcommon.init_embedding(cfg), "embed"),
        "groups": groups("groups", cfg.num_groups, cfg.is_encoder_decoder),
        "final_norm": torch.zeros((d,)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = draw(tcommon.param((cfg.padded_vocab, d),
                                               scale=0.02), "unembed")
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "groups": groups("encoder/groups", cfg.num_encoder_layers, False),
            "final_norm": torch.zeros((d,))}
        params["dec_pos_embed"] = draw(tcommon.param((8192, d), scale=0.02),
                                       "dec_pos_embed")
    if cfg.frontend == "image_patches":
        params["patch_adapter"] = draw(tcommon.param((d, d), scale=0.02),
                                       "patch_adapter")
    return params


@pytest.mark.parametrize("arch", tconfigs.PORTED)
def test_init_lm_bit_equal_to_stacked_blocks(arch):
    """Every ported smoke config, two seeds: the same leaves, keys, shapes,
    dtypes and bits as stacking drawn blocks."""
    cfg = tconfigs.get_smoke(arch)
    if cfg.num_groups == 1:  # one group stacks nothing: take two
        cfg = dataclasses.replace(cfg, num_layers=2 * len(cfg.pattern))
    for seed in (0, 3):
        got, got_def = flatten(TT.init_lm(cfg, seed=seed, device="cpu"))
        want, want_def = flatten(_stacked_init(cfg, seed))
        assert got_def == want_def
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w)
