"""The port's encoder-decoder (whisper_large_v3) against the JAX package,
on the CPU.

The smoke config (2 encoder + 2 decoder layers, d_model 64, 4 heads, 24
encoder frames, float32 unless a test says bf16) runs the weights of
``T.init_lm(jax.random.PRNGKey(0), cfg)`` through ``tree_from_jax``;
tokens and audio frames are made from a seed with numpy and handed to
both packages.  Covered: the config field for field, the sinusoidal
encoder positions bit for bit, the params and cache trees (``enc_out``
after ``b0``), ``lm_forward``, ``lm_loss`` and its gradients, a prefill
(encoder, cross-attention, ``enc_out`` written into the cache), decode
steps and an append chunk reading ``enc_out`` from the cache, the cache
through the port's ``Registry`` with decoding bit-equal after the pull,
the serving CLI, and the training CLI's failure, the same in both
packages.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import train as jtrain
from repro.models import common as jcommon
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import Registry
from repro_torch.convert import to_tensor, tree_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcommon
from repro_torch.models import config as tconfig
from repro_torch.models import transformer as TT
from repro_torch.tree import flatten, tree_map, unflatten

ARCH = "whisper_large_v3"
# float32: XLA and torch sum matmuls and softmaxes in other orders
# (test_torch_dense.py's bound; measured here: forward logits 3.3e-7
# apart, relative L2)
TOL_MODEL = dict(rtol=1e-4, atol=1e-5, rel_l2=1e-5)
# bfloat16: the two frameworks round bf16 intermediates at other places
# (test_torch_dense.py's bound, on the relative L2 error; measured here:
# forward logits 5.8e-3 apart)
TOL_MODEL_BF16 = dict(rtol=1e-1, atol=2.5e-1, rel_l2=5e-2)
# float32 gradients of lm_loss (test_torch_train.py's GRAD_TOL)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


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


def _batch(cfg, seed, B, S):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "frames": rng.normal(0, 0.02, (B, cfg.encoder_seq,
                                           cfg.d_model)).astype(np.float32)}


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
    assert ARCH in tconfigs.PORTED
    assert set(tconfigs.PORTED) == set(tconfigs.ARCHS)


@pytest.mark.parametrize("seq,dim", [(24, 64), (1500, 1280), (7, 10)])
def test_sinusoidal_positions_bit_equal(seq, dim):
    want = np.asarray(jcommon.sinusoidal_positions(seq, dim))
    got = tcommon.sinusoidal_positions(seq, dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_check_ported_raises_for_an_unknown_block_kind():
    """Every architecture passes ``check_ported``; a pattern whose mixer is
    an FFN kind still raises, from ``init_lm`` and ``init_cache`` too."""
    for arch in tconfigs.ARCHS:
        TT.check_ported(tconfigs.get_config(arch))
    bad = dataclasses.replace(tconfigs.get_smoke(ARCH), pattern=(
        (tconfig.BlockKind.MLP, tconfig.BlockKind.MLP),))
    for call in (lambda: TT.check_ported(bad),
                 lambda: TT.init_lm(bad, device="cpu"),
                 lambda: TT.init_cache(bad, 1, 8, device="cpu")):
        with pytest.raises(ValueError, match="no mixer"):
            call()


def test_params_and_cache_trees_identical_to_jax():
    """The converted params and the port's own ``init_lm`` have the
    reference's leaves (encoder groups, ``cross_attn``, ``norm_cross``,
    ``dec_pos_embed``), shapes and dtypes; ``init_cache`` leaves equal
    ``jax.tree.flatten`` of the reference's, ``enc_out`` after ``b0``."""
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
    for want in ("['dec_pos_embed']", "['encoder']['final_norm']",
                 "['groups']['b0']['cross_attn']['wk']",
                 "['encoder']['groups']['b0']['attn']['wq']"):
        assert any(want in n for n in names), want
    assert not any("['encoder']" in n and "cross" in n for n in names)
    for dtype in ("float32", "bfloat16"):
        jc = dataclasses.replace(jcfg, dtype=dtype)
        tc = dataclasses.replace(tcfg, dtype=dtype)
        jcache, tcache = JT.init_cache(jc, 2, 32), TT.init_cache(
            tc, 2, 32, device="cpu")
        _assert_trees_close(jcache, tcache, rtol=0, atol=0, rel_l2=0)
        assert list(jcache) == ["b0", "enc_out"]
        assert flatten(tcache)[1] == {"dict": {
            "b0": flatten(tcache["b0"])[1], "enc_out": "*"}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_forward_matches_jax(dtype):
    jcfg, jparams, tcfg, tparams = _models(dtype)
    batch = _batch(jcfg, 8, 2, 12)
    want = _jax_forward(jparams, jcfg, jax.tree.map(jnp.asarray, batch))
    got, _ = TT.lm_forward(tparams, _torch(batch), tcfg)
    assert got.dtype == torch.float32
    _assert_close(got, want, **_tol(dtype))


def test_encoder_is_bidirectional():
    """The encoder runs ``causal=False``: run causal, its output (and the
    logits through cross-attention) move far outside the tolerance."""
    _, _, tcfg, tparams = _models("float32")
    batch = _torch(_batch(tcfg, 3, 1, 6))
    enc = TT._encode(tparams, batch, tcfg)
    plain = TT._run_groups

    def causal(*args, **kwargs):
        return plain(*args, **{**kwargs, "causal": True})

    TT._run_groups = causal
    try:
        enc_causal = TT._encode(tparams, batch, tcfg)
    finally:
        TT._run_groups = plain
    err = (enc - enc_causal).norm() / enc.norm()
    assert err > 1e-2, err


def test_lm_loss_and_grads_match_jax():
    """float32: the loss, xent and every gradient leaf (the encoder's,
    cross-attention's and ``dec_pos_embed``'s included)."""
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
    for key in ("['encoder']['groups']['b0']['attn']['wq']",
                "['groups']['b0']['cross_attn']['wk']", "['dec_pos_embed']"):
        g, = [g for n, g in zip(names, tg) if n.startswith(key)]
        assert float(g.abs().max()) > 0, key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_calls_match_jax(dtype):
    """A 10-token prefill with frames (the encoder's output lands in the
    cache's ``enc_out``), 4 decode steps and a 3-token append, which read
    ``enc_out`` from the cache: logits and every cache leaf after each
    call."""
    jcfg, jparams, tcfg, tparams = _models(dtype)
    tol = _tol(dtype)
    B, max_seq, prompt = 2, 32, 10
    batch = _batch(jcfg, 9, B, prompt + 7)
    toks = batch.pop("tokens")
    batch["tokens"] = toks[:, :prompt]
    jcache = JT.init_cache(jcfg, B, max_seq)
    tcache = TT.init_cache(tcfg, B, max_seq, device="cpu")
    jl, jcache = _jax_prefill(jparams, jcfg, jcache,
                              jax.tree.map(jnp.asarray, batch))
    tl, tcache2 = TT.lm_prefill(tparams, _torch(batch), tcfg, tcache)
    assert tcache2 is tcache
    assert float(tcache["enc_out"].float().abs().max()) > 0
    _assert_close(tl, jl, **tol)
    _assert_trees_close(jcache, tcache, **tol)
    for t in range(prompt, prompt + 4):
        pos = np.full((B, 1), t, np.int32)
        jl, jcache = _jax_decode(jparams, jcfg, jcache,
                                 jnp.asarray(toks[:, t:t + 1]),
                                 jnp.asarray(pos))
        tl, tcache = TT.lm_decode_step(
            tparams, torch.from_numpy(toks[:, t:t + 1]),
            torch.from_numpy(pos), tcfg, tcache)
        _assert_close(tl, jl, **tol)
    _assert_trees_close(jcache, tcache, **tol)
    pos = np.broadcast_to(np.arange(prompt + 4, prompt + 7, dtype=np.int32),
                          (B, 3)).copy()
    jl, jcache = _jax_append(jparams, jcfg, jcache,
                             jnp.asarray(toks[:, prompt + 4:]),
                             jnp.asarray(pos))
    tl, tcache = TT.lm_append(tparams, torch.from_numpy(toks[:, prompt + 4:]),
                              torch.from_numpy(pos), tcfg, tcache)
    _assert_close(tl, jl, **tol)
    _assert_trees_close(jcache, tcache, **tol)


def test_cache_round_trips_the_registry(tmp_path):
    """The smoke cache after a prefill (K/V, pos and ``enc_out``), pushed
    and pulled through the port's registry: every leaf bit for bit, and 4
    decode steps from the pulled copy give the source's logits and cache
    bit for bit."""
    _, _, tcfg, tparams = _models("float32")
    B, prompt = 2, 8
    batch = _torch(_batch(tcfg, 6, B, prompt + 4))
    toks = batch.pop("tokens")
    batch["tokens"] = toks[:, :prompt]
    cache = TT.init_cache(tcfg, B, 32, device="cpu")
    _, cache = TT.lm_prefill(tparams, batch, tcfg, cache)
    reg = Registry(str(tmp_path))
    report = reg.push_image({"cache": cache})
    trees, _ = reg.pull_image(report.image_id)
    got, treedef = flatten(trees["cache"])
    pulled = unflatten(treedef, [to_tensor(a, "cpu") for a in got])
    assert flatten(pulled)[1] == flatten(cache)[1]
    for a, b in zip(flatten(pulled)[0], flatten(cache)[0]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    L, D = tcfg.num_layers, tcfg.resolved_head_dim
    assert report.total_bytes == (
        2 * L * B * 32 * tcfg.num_kv_heads * D * 4 + L * B * 32 * 4
        + B * tcfg.encoder_seq * tcfg.d_model * 4)
    outs = []
    for c in (tree_map(torch.clone, cache), pulled):
        lgs = []
        for t in range(prompt, prompt + 4):
            pos = torch.full((B, 1), t, dtype=torch.int32)
            lg, c = TT.lm_decode_step(tparams, toks[:, t:t + 1], pos, tcfg, c)
            lgs.append(lg)
        outs.append((torch.cat(lgs, 1), c))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(flatten(outs[0][1])[0],
                                                 flatten(outs[1][1])[0]))


def test_serve_cli_smoke(capsys):
    assert tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--decode-steps", "4"]) == 0
    out = capsys.readouterr().out
    for line in ("[serve] prefill 32 tokens x 8 requests: ",
                 "[serve] decoded 4 steps x 8 requests: ",
                 "[serve] sample continuation (request 0): "):
        assert line in out


def test_train_cli_fails_alike_without_frames(tmp_path):
    """Neither package's ``launch.train`` trains whisper: its data
    pipeline makes tokens and labels only, and the encoder reads
    ``batch["frames"]``, so both CLIs raise ``KeyError: 'frames'`` at the
    first step (the card path drives the train step itself, with frames:
    ``chip_smoke.py``'s train-whisper)."""
    argv = ["--arch", ARCH, "--smoke", "--steps", "1", "--ckpt-every", "100"]
    with pytest.raises(KeyError, match="frames"):
        jtrain.main(argv + ["--registry", str(tmp_path / "jax")])
    with pytest.raises(KeyError, match="frames"):
        ttrain.main(argv + ["--registry", str(tmp_path / "torch"),
                            "--device", "cpu"])
