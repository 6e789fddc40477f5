"""The port's VLM backbone (qwen2_vl_72b: M-RoPE over [3,B,S] ids and the
stub image-patch frontend) against the JAX package, on the CPU.

The smoke config (2 layers, d_model 64, 4 heads over 2, head_dim 16,
sections (8,12,12), 4 patches, float32 unless a test says bf16) runs the
weights of ``T.init_lm(jax.random.PRNGKey(0), cfg)`` through
``tree_from_jax``; tokens, patch embeddings and ids are made from a seed
with numpy and handed to both packages.  The ids follow an image: t runs
0..S-1, and inside the patch span (from token 1) h and w walk a 2 x 2
grid, so the three sections differ there.
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
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcommon
from repro_torch.models import config as tconfig
from repro_torch.models import transformer as TT
from repro_torch.tree import flatten, unflatten

ARCH = "qwen2_vl_72b"
# float32 through the smoke model: XLA and torch sum matmuls and softmaxes
# in other orders (test_torch_dense.py's bound; measured here: forward
# logits 4.3e-7 apart, relative L2)
TOL_MODEL = dict(rtol=1e-4, atol=1e-5, rel_l2=1e-5)
# bfloat16: the two frameworks round bf16 intermediates at other places
# (test_torch_dense.py's bound, on the relative L2 error; measured here:
# forward logits 7.5e-3 apart)
TOL_MODEL_BF16 = dict(rtol=1e-1, atol=2.5e-1, rel_l2=5e-2)
# float32 gradients of lm_loss (test_torch_train.py's GRAD_TOL)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# apply_mrope in float32: the same formula, cos and sin of the same
# float32 angles in two libms (measured: at most 2.4e-7 apart)
MROPE_TOL = dict(rtol=0, atol=1e-6)


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
    """Same keys (in ``jax.tree.flatten``'s order), shapes and dtypes;
    values within ``tol``, ``pos`` exact."""
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


@functools.lru_cache(maxsize=None)
def _models(dtype):
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype=dtype)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = tree_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def image_ids(B, S, P, side):
    """[3,B,S] ids: t = 0..S-1; inside the patch span (tokens 1..P, cut at
    S) patch j has h = 1 + j // side and w = 1 + j % side, elsewhere
    h = w = t."""
    t = np.arange(S, dtype=np.int32)
    h, w = t.copy(), t.copy()
    j = np.arange(min(P, S - 1))
    h[1:len(j) + 1] = 1 + j // side
    w[1:len(j) + 1] = 1 + j % side
    return np.broadcast_to(np.stack([t, h, w])[:, None], (3, B, S)).copy()


def _batch(cfg, seed, B, S):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "patch_embeds": rng.normal(0, 0.02, (B, cfg.num_patches,
                                             cfg.d_model)).astype(np.float32),
        "positions": image_ids(B, S, cfg.num_patches, 2)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_forward(params, cfg, batch):
    return JT.lm_forward(params, batch, cfg)[0]


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_prefill(params, cfg, cache, batch):
    return JT.lm_prefill(params, batch, cfg, cache)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_decode(params, cfg, cache, tokens, positions):
    return JT.lm_decode_step(params, tokens, positions, cfg, cache)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_append(params, cfg, cache, tokens, positions):
    return JT.lm_append(params, tokens, positions, cfg, cache)


@pytest.mark.parametrize("get", ["get_config", "get_smoke"])
def test_config_matches_jax(get):
    j = getattr(jconfigs, get)(ARCH)
    t = getattr(tconfigs, get)(ARCH)
    for f in dataclasses.fields(tconfig.ModelConfig):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if f.name == "pattern":
            a = tuple((m.value, n.value) for m, n in a)
            b = tuple((m.value, n.value) for m, n in b)
        assert a == b, f.name
    assert t.param_count() == j.param_count()


@pytest.mark.parametrize("sections,D", [((16, 24, 24), 128),
                                        ((8, 12, 12), 16), ((1, 2, 5), 22)])
def test_apply_mrope_matches_jax(sections, D):
    """Random [3,B,S] ids (the three components unequal), sections that
    rescale with a remainder, float32."""
    rng = np.random.default_rng(sum(sections) + D)
    x = rng.standard_normal((2, 9, 3, D)).astype(np.float32)
    ids = rng.integers(0, 300, (3, 2, 9)).astype(np.int32)
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(ids), sections,
                               1_000_000.0)
    got = tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(ids),
                              sections, 1_000_000.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MROPE_TOL)
    # each section takes its own component: permuted ids move the result
    swapped = tcommon.apply_mrope(torch.from_numpy(x),
                                  torch.from_numpy(ids[[1, 2, 0]]),
                                  sections, 1_000_000.0)
    assert float((swapped - got).abs().max()) > 1e-2


def test_mrope_of_text_ids_is_rope():
    """2-D ids broadcast to t = h = w, and equal ids give standard RoPE
    over the whole head, bit for bit; bf16 in, bf16 out, as the
    reference."""
    cfg = tconfigs.get_smoke(ARCH)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 7, 4, 16)).astype(
        np.float32))
    pos = torch.from_numpy(rng.integers(0, 4000, (2, 7)).astype(np.int32))
    got = tcommon.rope_for(cfg, x, pos, False)
    assert torch.equal(got, tcommon.rope_for(cfg, x, pos[None].expand(
        3, 2, 7), False))
    assert torch.equal(got, tcommon.apply_rope(x, pos, cfg.rope_theta))
    xb = x.to(torch.bfloat16)
    want = jcommon.rope_for(jconfigs.get_smoke(ARCH),
                            jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                            jnp.asarray(pos.numpy()), False)
    gotb = tcommon.rope_for(cfg, xb, pos, False)
    assert gotb.dtype == torch.bfloat16
    np.testing.assert_allclose(gotb.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("S", [7, 4, 3])
def test_patch_splice_matches_jax(S):
    """Patches written from token 1 with ``dynamic_update_slice``'s clamp:
    S > P writes from 1, S == P from 0, S < P raises ``TypeError`` in both
    packages."""
    jcfg, jparams, tcfg, tparams = _models("float32")
    P = tcfg.num_patches
    batch = _batch(jcfg, S, 2, S)
    batch["positions"] = np.broadcast_to(np.arange(S, dtype=np.int32),
                                         (2, S)).copy()
    if S < P:
        with pytest.raises(TypeError):
            JT._embed_inputs(jparams, jax.tree.map(jnp.asarray, batch), jcfg)
        with pytest.raises(TypeError):
            TT._embed_inputs(tparams, _torch(batch), tcfg)
        return
    jx, _ = JT._embed_inputs(jparams, jax.tree.map(jnp.asarray, batch), jcfg)
    tx, _ = TT._embed_inputs(tparams, _torch(batch), tcfg)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-6)
    start = 1 if S > P else 0
    plain = TT._embed_inputs(tparams, {"tokens": torch.from_numpy(
        batch["tokens"])}, tcfg)[0]
    kept = [i for i in range(S) if not start <= i < start + P]
    assert torch.equal(tx[:, kept], plain[:, kept])
    assert not torch.equal(tx[:, start], plain[:, start])


def test_params_and_cache_trees_identical_to_jax():
    jcfg, jparams, tcfg, tparams = _models("float32")
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tleaves, _ = flatten(tparams)
    own = flatten(TT.init_lm(tcfg, seed=0, device="cpu"))[0]
    assert len(jflat) == len(tleaves) == len(own)
    for (path, j), t, o in zip(jflat, tleaves, own):
        assert tuple(t.shape) == tuple(o.shape) == j.shape, path
        assert t.dtype == o.dtype, path
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    names = [jax.tree_util.keystr(p) for p, _ in jflat]
    assert any("['patch_adapter']" in n for n in names)
    assert any("['unembed']" in n for n in names)
    _assert_trees_close(JT.init_cache(jcfg, 2, 32),
                        TT.init_cache(tcfg, 2, 32, device="cpu"),
                        rtol=0, atol=0, rel_l2=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_forward_matches_jax(dtype):
    jcfg, jparams, tcfg, tparams = _models(dtype)
    batch = _batch(jcfg, 8, 2, 12)
    want = _jax_forward(jparams, jcfg, jax.tree.map(jnp.asarray, batch))
    got, _ = TT.lm_forward(tparams, _torch(batch), tcfg)
    assert got.dtype == torch.float32
    _assert_close(got, want, **_tol(dtype))


def test_lm_loss_and_grads_match_jax():
    """float32: the loss, xent and every gradient leaf
    (``patch_adapter``'s included)."""
    jcfg, jparams, tcfg, tparams = _models("float32")
    batch = _batch(jcfg, 11, 2, 12)
    labels = np.random.default_rng(12).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    labels[0, :3] = -1
    batch["labels"] = labels
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(p, jax.tree.map(jnp.asarray, batch), jcfg),
        has_aux=True))(jparams)
    flat, treedef = flatten(tparams)
    flat = [t.detach().clone().requires_grad_(True) for t in flat]
    tl, tm = TT.lm_loss(unflatten(treedef, flat), _torch(batch), tcfg)
    tg = torch.autograd.grad(tl, flat)
    tl, tm = tl.detach(), {k: v.detach() for k, v in tm.items()}
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["xent"]), float(jm["xent"]),
                               rtol=1e-5)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for t, j in zip(tg, jleaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **GRAD_TOL)
    names = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    g, = [g for n, g in zip(names, tg) if n.startswith("['patch_adapter']")]
    assert float(g.abs().max()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_calls_match_jax(dtype):
    """A 10-token prefill with patches and [3,B,S] image ids (cache slots
    keyed by t), 4 decode steps with [3,B,1] ids and a 3-token append with
    [B,k] ids: logits and every cache leaf after each call."""
    jcfg, jparams, tcfg, tparams = _models(dtype)
    tol = _tol(dtype)
    B, max_seq, prompt = 2, 32, 10
    batch = _batch(jcfg, 9, B, prompt)
    toks = np.random.default_rng(10).integers(
        0, jcfg.vocab_size, (B, 7)).astype(np.int32)
    jcache = JT.init_cache(jcfg, B, max_seq)
    tcache = TT.init_cache(tcfg, B, max_seq, device="cpu")
    jl, jcache = _jax_prefill(jparams, jcfg, jcache,
                              jax.tree.map(jnp.asarray, batch))
    tl, tcache = TT.lm_prefill(tparams, _torch(batch), tcfg, tcache)
    _assert_close(tl, jl, **tol)
    _assert_trees_close(jcache, tcache, **tol)
    assert tcache["b0"]["pos"][0, 0, :prompt].tolist() == list(range(prompt))
    for i in range(4):
        t = prompt + i
        pos = np.full((3, B, 1), t, np.int32)
        jl, jcache = _jax_decode(jparams, jcfg, jcache,
                                 jnp.asarray(toks[:, i:i + 1]),
                                 jnp.asarray(pos))
        tl, tcache = TT.lm_decode_step(
            tparams, torch.from_numpy(toks[:, i:i + 1]),
            torch.from_numpy(pos), tcfg, tcache)
        _assert_close(tl, jl, **tol)
    _assert_trees_close(jcache, tcache, **tol)
    pos = np.broadcast_to(np.arange(prompt + 4, prompt + 7, dtype=np.int32),
                          (B, 3)).copy()
    jl, jcache = _jax_append(jparams, jcfg, jcache, jnp.asarray(toks[:, 4:]),
                             jnp.asarray(pos))
    tl, tcache = TT.lm_append(tparams, torch.from_numpy(toks[:, 4:]),
                              torch.from_numpy(pos), tcfg, tcache)
    _assert_close(tl, jl, **tol)
    _assert_trees_close(jcache, tcache, **tol)


def test_serve_cli_smoke(capsys):
    assert tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--decode-steps", "4"]) == 0
    out = capsys.readouterr().out
    for line in ("[serve] prefill 32 tokens x 8 requests: ",
                 "[serve] decoded 4 steps x 8 requests: ",
                 "[serve] sample continuation (request 0): "):
        assert line in out
