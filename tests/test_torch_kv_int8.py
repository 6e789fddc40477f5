"""The port's int8 KV cache against the JAX package's, on the CPU.

The cache stores K and V as int8 with one bf16 scale per (slot, kv head):
``scale = max|x| / 127`` (a float32 true division, at least 1e-8), values
``round(x / scale)`` half to even, clipped to +-127; attention reads them
back as their product in the compute dtype.  Inputs are made from a seed
with numpy; the models run the weights of
``T.init_lm(jax.random.PRNGKey(0), cfg)`` (through ``tree_from_jax``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattention
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import Registry
from repro_torch.convert import to_tensor, tree_from_jax
from repro_torch.models import attention as tattention
from repro_torch.models import transformer as TT
from repro_torch.tree import flatten, tree_map, unflatten

ARCHS = ("paper_consumer", "codeqwen1_5_7b", "gemma3_4b")
# float32 models: K and V agree to about 1e-7 between XLA and torch, so a
# value next to a rounding boundary may quantize one step apart, which
# moves later logits.  Measured on the CPU over every call: at most
# 4.5e-7 apart for paper_consumer and codeqwen, 1.75e-4 for gemma3 (17
# layers)
TOL_LOGITS = dict(rtol=1e-3, atol=1e-3)


def _bits(a):
    """A tensor or a JAX/numpy array as numpy, bf16 as its uint16 bits."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _quantize_both(x):
    """x (numpy, float32 or bf16) through both packages' quantizers."""
    jq, js = jattention._quantize_kv(jnp.asarray(x))
    tq, ts = tattention._quantize_kv(to_tensor(x, "cpu"))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert tq.shape == jq.shape and ts.shape == js.shape
    return (jq, js), (tq, ts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 9, 4, 16), (3, 1, 2, 128),
                                   (1, 5, 32, 256)])
def test_quantized_leaves_bit_identical_to_reference(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32) * rng.uniform(
        1e-3, 30.0, shape[:-1] + (1,)).astype(np.float32)
    if dtype == "bfloat16":  # round once, hand both packages the same bits
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    (jq, js), (tq, ts) = _quantize_both(x)
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))


def test_halves_round_to_even():
    """A row whose largest |x| is 127 has scale 1, so x / scale keeps its
    halves: each rounds to the even neighbour, as ``jnp.round`` does."""
    row = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                   np.float32)
    (jq, js), (tq, ts) = _quantize_both(row[None])
    assert tq[0].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    assert ts.float().item() == 1.0
    np.testing.assert_array_equal(_bits(ts), _bits(js))


def test_zero_rows_take_the_clamp():
    """An all-zero row gets scale 1e-8 (in bf16) and zero values; the
    other rows are untouched by the clamp."""
    x = np.zeros((2, 3, 8), np.float32)
    x[1, 2] = np.linspace(-1, 1, 8)
    (jq, js), (tq, ts) = _quantize_both(x)
    want = torch.tensor(1e-8, dtype=torch.float32).to(torch.bfloat16)
    assert bool((ts[0] == want).all()) and bool((ts[1, :2] == want).all())
    assert ts[1, 2].item() != want.item()
    assert not bool(tq[0].any()) and not bool(tq[1, :2].any())
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))


def test_dequantize_is_the_product_in_the_compute_dtype():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 3, 16)).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        (jq, js), (tq, ts) = _quantize_both(x)
        jk, jv = jattention._dequantize_kv(
            {"k": jq, "v": jq, "k_scale": js, "v_scale": js}, jdt)
        tk, tv = tattention._dequantize_kv(
            {"k": tq, "v": tq, "k_scale": ts, "v_scale": ts}, dt)
        assert tk.dtype == dt
        np.testing.assert_array_equal(_bits(tk), _bits(jk))
        np.testing.assert_array_equal(_bits(tv), _bits(jv))


def _cfgs(arch):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                               kv_cache_dtype="int8")
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch),
                               kv_cache_dtype="int8")
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg, tcfg = _cfgs(arch)
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


def _assert_int8_cache_close(jcache, tcache):
    """Same keys, shapes and dtypes as ``jax.tree.flatten`` gives; ``pos``
    exact; int8 values at most one step apart and nearly all equal (K and
    V differ by float32 sum order; measured on the CPU: at worst 99.41 %
    of a leaf's values equal, the rest one step apart); scales (bf16) to
    bf16 rounding."""
    jflat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    tleaves, _ = flatten(tcache)
    assert len(jflat) == len(tleaves)
    for (path, j), t in zip(jflat, tleaves):
        name = jax.tree_util.keystr(path)
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape, name
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name, name
        if name.endswith("['pos']"):
            np.testing.assert_array_equal(t.numpy(), j, name)
        elif t.dtype == torch.int8:
            diff = np.abs(t.numpy().astype(np.int32) - j.astype(np.int32))
            assert diff.max() <= 1 and (diff == 0).mean() >= 0.98, name
        else:
            np.testing.assert_allclose(t.float().numpy(), j.astype(np.float32),
                                       rtol=1e-2, atol=1e-6, err_msg=name)


def test_int8_cache_tree_matches_jax():
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        jcache = JT.init_cache(jcfg, 2, 16)
        tcache = TT.init_cache(tcfg, 2, 16, device="cpu")
        names = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(jcache)[0]]
        assert any(n.endswith("['k_scale']") for n in names)
        _assert_int8_cache_close(jcache, tcache)
        for leaf in flatten(tcache)[0]:
            assert not bool(leaf.float().clamp(min=0).any())


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_decode_matches_jax(arch):
    """24 decode steps into an int8 cache from empty (the reference's
    ``test_int8_kv_cache_decode_close``), each step's logits against the
    JAX package's, and the int8 run within that test's 0.15 of the float
    cache's."""
    jcfg, jparams, tcfg, tparams = _models(arch)
    B, S = 2, 24
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jcache = JT.init_cache(jcfg, B, 32)
    tcache = TT.init_cache(tcfg, B, 32, device="cpu")
    float_cfg = dataclasses.replace(tcfg, kv_cache_dtype="")
    fcache = TT.init_cache(float_cfg, B, 32, device="cpu")
    for t in range(S):
        pos = np.full((B, 1), t, np.int32)
        jl, jcache = _jax_decode(jparams, jcfg, jcache,
                                 jnp.asarray(toks[:, t:t + 1]),
                                 jnp.asarray(pos))
        tl, tcache = TT.lm_decode_step(
            tparams, torch.from_numpy(toks[:, t:t + 1]),
            torch.from_numpy(pos), tcfg, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_LOGITS)
        fl, fcache = TT.lm_decode_step(
            tparams, torch.from_numpy(toks[:, t:t + 1]),
            torch.from_numpy(pos), float_cfg, fcache)
    _assert_int8_cache_close(jcache, tcache)
    assert (tl - fl).abs().max().item() < 0.15


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_prefill_and_append_match_jax(arch):
    """A 12-token prefill (past gemma3's 8-slot ring), 3 decode steps and
    a 5-token append into an int8 cache: logits and every cache leaf."""
    jcfg, jparams, tcfg, tparams = _models(arch)
    B = 2
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (B, 20)).astype(np.int32)
    jcache = JT.init_cache(jcfg, B, 32)
    tcache = TT.init_cache(tcfg, B, 32, device="cpu")
    jl, jcache = _jax_prefill(jparams, jcfg, jcache, jnp.asarray(toks[:, :12]))
    tl, tcache = TT.lm_prefill(
        tparams, {"tokens": torch.from_numpy(toks[:, :12])}, tcfg, tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_LOGITS)
    _assert_int8_cache_close(jcache, tcache)
    for t in range(12, 15):
        pos = np.full((B, 1), t, np.int32)
        jl, jcache = _jax_decode(jparams, jcfg, jcache,
                                 jnp.asarray(toks[:, t:t + 1]),
                                 jnp.asarray(pos))
        tl, tcache = TT.lm_decode_step(
            tparams, torch.from_numpy(toks[:, t:t + 1]),
            torch.from_numpy(pos), tcfg, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_LOGITS)
    pos = np.broadcast_to(np.arange(15, 20, dtype=np.int32), (B, 5)).copy()
    jl, jcache = _jax_append(jparams, jcfg, jcache, jnp.asarray(toks[:, 15:]),
                             jnp.asarray(pos))
    tl, tcache = TT.lm_append(tparams, torch.from_numpy(toks[:, 15:]),
                              torch.from_numpy(pos), tcfg, tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_LOGITS)
    _assert_int8_cache_close(jcache, tcache)


def test_int8_cache_round_trips_the_registry(tmp_path):
    """An int8 cache after a prefill, pushed and pulled through the port's
    registry: every leaf bit for bit, and 6 decode steps from the pulled
    copy give the source's logits and cache bit for bit."""
    _, _, tcfg, tparams = _models("codeqwen1_5_7b")
    B = 2
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (B, 16)).astype(np.int32))
    cache = TT.init_cache(tcfg, B, 32, device="cpu")
    logits, cache = TT.lm_prefill(tparams, {"tokens": toks[:, :10]}, tcfg,
                                  cache)
    reg = Registry(str(tmp_path))
    report = reg.push_image({"cache": cache})
    trees, _ = reg.pull_image(report.image_id)
    leaves, treedef = flatten(trees["cache"])
    pulled = unflatten(treedef, [to_tensor(a, "cpu") for a in leaves])
    assert flatten(pulled)[1] == flatten(cache)[1]
    for a, b in zip(flatten(pulled)[0], flatten(cache)[0]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    kv = sum(leaf.nbytes for leaf in flatten(cache)[0]
             if leaf.dtype in (torch.int8, torch.bfloat16))
    L, S, H, D = tcfg.num_layers, 32, tcfg.num_kv_heads, tcfg.resolved_head_dim
    assert kv == L * B * S * H * (2 * D + 2 * 2)  # int8 K, V; bf16 scales
    outs = []
    for c in (tree_map(torch.clone, cache), pulled):
        lgs = []
        for t in range(10, 16):
            pos = torch.full((B, 1), t, dtype=torch.int32)
            lg, c = TT.lm_decode_step(tparams, toks[:, t:t + 1], pos, tcfg, c)
            lgs.append(lg)
        outs.append((torch.cat(lgs, 1), c))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(flatten(outs[0][1])[0],
                                                 flatten(outs[1][1])[0]))
