"""The port's xLSTM path (xlstm_350m: mLSTM and sLSTM blocks) against the
JAX package, on the CPU.

Inputs are made from a seed with numpy and handed to both packages; the
models run the weights of ``T.init_lm(jax.random.PRNGKey(0), cfg)``
(through ``tree_from_jax``).  The JAX package's Pallas mLSTM and sLSTM
kernels run in interpret mode, as its own tests run them.
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
from repro.kernels.mlstm import mlstm as pl_mlstm
from repro.kernels.slstm import slstm as pl_slstm
from repro.models import transformer as JT
from repro.models import xlstm as jxlstm
from repro_torch import configs as tconfigs
from repro_torch.convert import to_tensor, tree_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import config as tconfig
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as txlstm
from repro_torch.tree import flatten, unflatten

# float32, the same function: sums over D and over the chunk run in
# another order in XLA and torch (h reaches |h| ~ 30 at these shapes, so
# the bound is relative to the largest |h|)
TOL_F32 = dict(rtol=1e-5, atol=1e-5)
# tests/test_kernels.py's tolerances for the Pallas mLSTM kernel against
# the recurrence: float32, and bf16 inputs (bf16 output rounding of values
# up to ~30, and the chunkwise against the recurrent sum order)
TOL_MLSTM32 = dict(rtol=1e-4, atol=1e-5)
TOL_MLSTM_BF16 = dict(rtol=5e-2, atol=0.3)
# the port's chunkwise plain version against the Pallas kernel on the same
# bf16 inputs: both round h once to bf16 (one ulp is 2**-7 relative)
TOL_BF16_OUT = dict(rtol=1e-2, atol=1e-2)
# float32 through the smoke model's 8 layers.  The per-head rms_norm of
# the mLSTM output is steep: where k.q is near 0 the head's h is v (k.q)
# e^{logi}, which the norm turns into +-v/|v| over a width of about
# sqrt(norm_eps).  At the config's norm_eps 1e-6 it turns float32 sum-order
# differences into about 1e-3 of the logits: the JAX package's own two
# paths (recurrence, Pallas kernel in interpret mode) lie 1.8e-3 apart
# (relative L2) on test_lm_forward's input, and the port's gradients
# 3e-3 from JAX's.  With norm_eps 1e-2 the same spread is 3.6e-6, and the
# gradients' 1e-4: the tests run both, the tight bound on the second.
TOL_MODEL = dict(rtol=2e-4, atol=2e-5)
TOL_MODEL_STEEP = dict(rtol=0, atol=1e-2, rel_l2=5e-3)
GRAD_REL = {1e-6: 1e-2, 1e-2: 5e-4}
# bfloat16 through 8 layers: XLA and torch round bf16 intermediates at
# other places; bounded on the relative L2 error (as the recurrentgemma
# tests do), with a loose elementwise bound beside it
TOL_MODEL_BF16 = dict(rtol=1e-1, atol=2.5e-1, rel_l2=1e-1)
# cache leaves after a prefill / decode / append: C and n sum up to |x| ~
# 1e3 over the prompt, so bound the error relative to the leaf's largest
# entry.  In bf16 the first layer's state agrees to 1e-7 and the bf16
# rounding differences grow through the layers, to 7-10 % at the sLSTM of
# layer 8 (the logits' bound above allows as much)
TOL_STATE = dict(rel=2e-5)
TOL_STATE_BF16 = dict(rel=1.5e-1)


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: torch's intra-op threads cost more than
    they save, and beside other test processes they oversubscribe the
    cores (the suite runs files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _torch(*arrays):
    return [to_tensor(a, "cpu") for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _round(a, dtype):
    """``a`` rounded once to ``dtype`` (numpy), the same bits for both."""
    return a if dtype == "float32" else np.asarray(
        jnp.asarray(a, jnp.bfloat16))


def _mlstm_inputs(seed, B, S, H, D, dtype="float32"):
    rng = np.random.default_rng(seed)
    q, k, v = (_round(rng.standard_normal((B, S, H, D)).astype(np.float32),
                      dtype) for _ in range(3))
    ig = rng.standard_normal((B, S, H)).astype(np.float32)
    fg = (rng.standard_normal((B, S, H)) + 2.0).astype(np.float32)
    return q, k, v, ig, fg


def _slstm_inputs(seed, B, S, H, hb, dtype="float32"):
    rng = np.random.default_rng(seed)
    xs = [_round(rng.standard_normal((B, S, H * hb)).astype(np.float32),
                 dtype) for _ in range(4)]
    rs = [(rng.standard_normal((H, hb, hb)) * 0.2).astype(np.float32)
          for _ in range(4)]
    return xs + rs


def _close_to_scale(got, want, rel, name=""):
    """max |got - want| <= rel * max |want| (state leaves that grow)."""
    got, want = _f32(got), _f32(want)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (name, err)


# ---------------------------------------------------------------------------
# the plain versions against the reference's functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("B,S,H,D", [(1, 64, 2, 32), (2, 128, 4, 64)])
def test_chunkwise_mlstm_matches_pallas_kernel(B, S, H, D, chunk, dtype):
    """The port's chunkwise plain version against the TPU kernel in
    interpret mode (same chunk, so the same function and output dtype)
    and against the recurrence, at tests/test_kernels.py's shapes."""
    arrays = _mlstm_inputs(1, B, S, H, D, dtype)
    want = pl_mlstm(*_jax(*arrays), chunk=chunk, interpret=True)
    got = ref.chunkwise_mlstm(*_torch(*arrays), chunk=chunk)
    assert str(got.dtype).removeprefix("torch.") == dtype == want.dtype.name
    rec, _ = jref.naive_mlstm(*_jax(*[a.astype(np.float32)
                                      for a in arrays]))
    if dtype == "float32":
        scale = np.abs(np.asarray(want)).max()
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                                   atol=TOL_F32["atol"] * scale)
        np.testing.assert_allclose(_f32(got), _f32(rec), **TOL_MLSTM32)
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL_BF16_OUT)
        np.testing.assert_allclose(_f32(got), _f32(rec), **TOL_MLSTM_BF16)


@pytest.mark.parametrize("S", [1, 12, 40])
def test_chunkwise_mlstm_matches_recurrence_any_length(S):
    """Chunks of 128 halved until they divide S (40 -> 8, 12 -> 4, 1 -> 1),
    as ``ops.mlstm_scan`` picks them, against the recurrence."""
    arrays = _torch(*_mlstm_inputs(2, 2, S, 3, 16))
    got, state = ops.mlstm_scan(*arrays)
    assert state is None
    want, _ = ref.naive_mlstm(*arrays)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL_MLSTM32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("B,S,H,hb", [(1, 32, 2, 16), (2, 64, 4, 32)])
def test_slstm_plain_matches_pallas_kernel(B, S, H, hb, chunk, dtype):
    """``naive_slstm`` with no state (the sLSTM kernel's plain version)
    against the TPU kernel in interpret mode and the reference's
    recurrence, at tests/test_kernels.py's shapes."""
    arrays = _slstm_inputs(3, B, S, H, hb, dtype)
    want = pl_slstm(*_jax(*arrays), chunk=chunk, interpret=True)
    want_rec, _ = jref.naive_slstm(*_jax(*arrays))
    got, _ = ref.naive_slstm(*_torch(*arrays))
    assert str(got.dtype).removeprefix("torch.") == dtype == want.dtype.name
    tol = TOL_F32 if dtype == "float32" else TOL_BF16_OUT
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    np.testing.assert_allclose(_f32(got), _f32(want_rec), **tol)


def test_naive_mlstm_carries_state_like_jax():
    """The recurrence from a carried state: two calls (the second from the
    first's (C, n, m)), then two decode steps, each against the JAX
    package's."""
    arrays = _mlstm_inputs(4, 2, 22, 3, 16)
    jh1, jst = jref.naive_mlstm(*_jax(*[a[:, :13] for a in arrays]))
    th1, tst = ref.naive_mlstm(*_torch(*[a[:, :13] for a in arrays]))
    assert th1.dtype == torch.float32 and len(tst) == 3
    jh2, jst = jref.naive_mlstm(*_jax(*[a[:, 13:20] for a in arrays]), jst)
    th2, tst = ref.naive_mlstm(*_torch(*[a[:, 13:20] for a in arrays]), tst)
    for g, w in ((th1, jh1), (th2, jh2)):
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL_MLSTM32)
    for t in (20, 21):
        step = [a[:, t] for a in arrays]
        jst, jh = jref.mlstm_decode_step(jst, *_jax(*step))
        tst, th = ref.mlstm_decode_step(tst, *_torch(*step))
        np.testing.assert_allclose(_f32(th), _f32(jh), **TOL_MLSTM32)
    for g, w in zip(tst, jst):
        _close_to_scale(g, w, **TOL_STATE)
    # and the chunkwise form of the whole sequence gives the same h
    whole, _ = ops.mlstm_scan(*_torch(*[a[:, :20] for a in arrays]))
    np.testing.assert_allclose(_f32(whole), np.concatenate(
        [_f32(th1), _f32(th2)], 1), **TOL_MLSTM32)


def test_naive_slstm_carries_state_like_jax():
    arrays = _slstm_inputs(5, 2, 30, 2, 24)
    xs, rs = arrays[:4], arrays[4:]
    jh, jst = jref.naive_slstm(*_jax(*[x[:, :17] for x in xs], *rs))
    th, tst = ref.naive_slstm(*_torch(*[x[:, :17] for x in xs], *rs))
    np.testing.assert_allclose(_f32(th), _f32(jh), **TOL_F32)
    jh, jst = jref.naive_slstm(*_jax(*[x[:, 17:] for x in xs], *rs), jst)
    th, tst = ref.naive_slstm(*_torch(*[x[:, 17:] for x in xs], *rs), tst)
    np.testing.assert_allclose(_f32(th), _f32(jh), **TOL_F32)
    assert len(tst) == 4
    for g, w in zip(tst, jst):
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL_F32)


def test_ops_scans_on_cpu():
    """On the CPU a fresh-state call runs the kernels' plain versions, a
    call with state the recurrences (returning the state)."""
    m = _torch(*_mlstm_inputs(6, 2, 16, 2, 8))
    h, st = ops.mlstm_scan(*m)
    assert st is None and torch.equal(h, ref.chunkwise_mlstm(*m, chunk=16))
    fresh = ref.naive_mlstm(*m)[1]
    h, st = ops.mlstm_scan(*m, state=fresh)
    want_h, want_st = ref.naive_mlstm(*m, fresh)
    assert torch.equal(h, want_h) and len(st) == 3
    assert all(torch.equal(a, b) for a, b in zip(st, want_st))
    s = _torch(*_slstm_inputs(7, 2, 9, 2, 8))
    h, st = ops.slstm_scan(*s)
    want_h, want_st = ref.naive_slstm(*s)
    assert torch.equal(h, want_h) and len(st) == 4
    h, st = ops.slstm_scan(*s, state=want_st)
    assert torch.equal(h, ref.naive_slstm(*s, want_st)[0])


# ---------------------------------------------------------------------------
# the blocks and the model
# ---------------------------------------------------------------------------

def _cfgs(dtype="float32", norm_eps=1e-6):
    jcfg = dataclasses.replace(jconfigs.get_smoke("xlstm_350m"), dtype=dtype,
                               norm_eps=norm_eps)
    tcfg = dataclasses.replace(tconfigs.get_smoke("xlstm_350m"), dtype=dtype,
                               norm_eps=norm_eps)
    assert (jcfg.name, jcfg.num_layers, jcfg.d_model) == \
        (tcfg.name, tcfg.num_layers, tcfg.d_model) == ("xlstm-350m", 8, 64)
    return jcfg, tcfg


def _assert_close(got, want, err_msg="", *, rtol, atol, rel_l2=None):
    got, want = _f32(got), _f32(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=err_msg)
    if rel_l2 is not None:
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= rel_l2, (err_msg, err)


def _assert_cache_close(jtree, ttree, rel):
    """Same leaf order, shapes and dtypes as ``jax.tree.flatten``; values
    within ``rel`` of each leaf's scale."""
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tleaves, _ = flatten(ttree)
    assert len(jflat) == len(tleaves)
    for (path, j), t in zip(jflat, tleaves):
        name = jax.tree_util.keystr(path)
        assert tuple(t.shape) == j.shape, name
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name, name
        _close_to_scale(t, j, rel, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_forward_and_decode_carry_state(kind, dtype):
    """One block: a 12-token forward from a fresh state (the kernels'
    plain versions), a 6-token forward from the init state and 3 decode
    steps from the carried one (the recurrences)."""
    jcfg, tcfg = _cfgs(dtype)
    jinit = getattr(jxlstm, f"init_{kind}_block")
    jparams = jinit(jax.random.PRNGKey(1), jcfg)
    tparams = tree_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    jfwd = getattr(jxlstm, f"{kind}_block_forward")
    tfwd = getattr(txlstm, f"{kind}_block_forward")
    jdec = getattr(jxlstm, f"{kind}_decode_step")
    tdec = getattr(txlstm, f"{kind}_decode_step")
    rng = np.random.default_rng(8)
    xs = _round(rng.standard_normal((2, 12, jcfg.d_model)).astype(
        np.float32), dtype)
    if dtype == "float32":
        tol, rel = dict(rtol=1e-4, atol=1e-5), TOL_STATE["rel"]
    else:
        tol, rel = TOL_MODEL_BF16, TOL_STATE_BF16["rel"]
    jy, _ = jfwd(jparams, jnp.asarray(xs), jcfg)
    ty, _ = tfwd(tparams, to_tensor(xs, "cpu"), tcfg)
    _assert_close(ty, jy, **tol)
    jstate = getattr(jxlstm, f"init_{kind}_state")(jcfg, 2)
    tstate = getattr(txlstm, f"init_{kind}_state")(tcfg, 2, device="cpu")
    jy, jstate = jfwd(jparams, jnp.asarray(xs[:, :6]), jcfg, jstate)
    ty, tstate = tfwd(tparams, to_tensor(xs[:, :6], "cpu"), tcfg, tstate)
    _assert_close(ty, jy, **tol)
    _assert_cache_close(jstate, tstate, rel)
    for t in range(6, 9):
        jy, jstate = jdec(jparams, jnp.asarray(xs[:, t:t + 1]), jcfg,
                          jstate)
        ty, tstate = tdec(tparams, to_tensor(xs[:, t:t + 1], "cpu"), tcfg,
                          tstate)
        _assert_close(ty, jy, **tol)
    _assert_cache_close(jstate, tstate, rel)
    assert isinstance(tstate, tuple) and all(
        a.dtype == torch.float32 for a in tstate)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_states_match_jax(kind):
    jcfg, tcfg = _cfgs()
    _assert_cache_close(
        getattr(jxlstm, f"init_{kind}_state")(jcfg, 3),
        getattr(txlstm, f"init_{kind}_state")(tcfg, 3, device="cpu"), 0.0)


@functools.lru_cache(maxsize=None)
def _models(dtype, norm_eps=1e-6):
    jcfg, tcfg = _cfgs(dtype, norm_eps)
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


def test_params_and_cache_trees_identical_to_jax():
    jcfg, jparams, tcfg, tparams = _models("float32")
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tleaves, _ = flatten(tparams)
    own = flatten(TT.init_lm(tcfg, seed=0, device="cpu"))[0]
    assert len(jflat) == len(tleaves) == len(own)
    names = {jax.tree_util.keystr(p) for p, _ in jflat}
    for key in ("w_up", "w_gate", "wq", "wk", "wv", "w_if", "b_if",
                "out_norm", "w_down"):
        assert any(n.startswith(f"['groups']['b0']['mlstm']['{key}']")
                   for n in names), key
    for key in ("w_out", "w_i", "r_f", "b_z", "r_o"):
        assert any(n.startswith(f"['groups']['b7']['slstm']['{key}']")
                   for n in names), key
    for (path, j), t, o in zip(jflat, tleaves, own):
        assert tuple(t.shape) == tuple(o.shape) == j.shape, path
        assert t.dtype == o.dtype, path
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # the cache: tuples (C, n, m) and (c, n, h, m) stacked over the group,
    # in jax.tree.flatten's order, with its shapes, dtypes and values
    jcache = JT.init_cache(jcfg, 2, 32)
    tcache = TT.init_cache(tcfg, 2, 32, device="cpu")
    assert isinstance(tcache["b0"], tuple) and len(tcache["b0"]) == 3
    assert isinstance(tcache["b7"], tuple) and len(tcache["b7"]) == 4
    _assert_cache_close(jcache, tcache, 0.0)


@pytest.mark.parametrize("norm_eps", [1e-6, 1e-2])
def test_lm_forward_float32_matches_jax(norm_eps):
    """The JAX package's CPU path (the recurrences) against the port's
    (the kernels' plain versions: chunkwise mLSTM, fresh-state sLSTM)."""
    jcfg, jparams, tcfg, tparams = _models("float32", norm_eps)
    toks = np.random.default_rng(9).integers(
        0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    want, _ = jax.jit(JT.lm_forward, static_argnames=("cfg",))(
        jparams, {"tokens": jnp.asarray(toks)}, cfg=jcfg)
    got, _ = TT.lm_forward(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert got.dtype == torch.float32
    _assert_close(got, want, **(TOL_MODEL_STEEP if norm_eps == 1e-6
                                else TOL_MODEL))


def test_lm_forward_bf16_matches_jax_pallas_kernels(monkeypatch):
    """bf16: the JAX side through its Pallas kernels in interpret mode
    (``REPRO_FORCE_PALLAS_INTERPRET``, read when the call is traced), so
    that both sides compute the kernels' function and output dtype."""
    jcfg, jparams, tcfg, tparams = _models("bfloat16")
    toks = np.random.default_rng(10).integers(
        0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    monkeypatch.setenv("REPRO_FORCE_PALLAS_INTERPRET", "1")
    want, _ = JT.lm_forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    got, _ = TT.lm_forward(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    _assert_close(got, want, **TOL_MODEL_BF16)
    # and the JAX package's recurrences (float32 mLSTM output) are a
    # different rounding of the same function: within the same bound
    monkeypatch.delenv("REPRO_FORCE_PALLAS_INTERPRET")
    rec, _ = JT.lm_forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    _assert_close(got, rec, **TOL_MODEL_BF16)


@pytest.mark.parametrize("norm_eps", [1e-6, 1e-2])
def test_lm_loss_gradients_match_jax(norm_eps):
    """float32 ``lm_loss`` gradients of every parameter (the port through
    the kernels' plain versions under autograd, the JAX package through
    its recurrences), relative to each leaf's largest gradient."""
    jcfg, jparams, tcfg, tparams = _models("float32", norm_eps)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -1
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(p, jbatch, jcfg), has_aux=True))(jparams)
    leaves, treedef = flatten(tparams)
    trainable = [t.clone().requires_grad_() for t in leaves]
    tp = unflatten(treedef, trainable)
    tloss, _ = TT.lm_loss(tp, {"tokens": torch.from_numpy(toks),
                               "labels": torch.from_numpy(labels)}, tcfg)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(trainable)
    for (path, j), t in zip(jflat, trainable):
        _close_to_scale(t.grad, j, GRAD_REL[norm_eps],
                        jax.tree_util.keystr(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_calls_match_jax(dtype):
    """A 20-token prefill, 6 decode steps and a 5-token append: logits and
    every cache leaf after each call."""
    jcfg, jparams, tcfg, tparams = _models(dtype)
    tol = TOL_MODEL if dtype == "float32" else TOL_MODEL_BF16
    rel = TOL_STATE["rel"] if dtype == "float32" else TOL_STATE_BF16["rel"]
    B, prompt, max_seq = 2, 20, 48
    toks = np.random.default_rng(12).integers(
        0, jcfg.vocab_size, (B, prompt + 11)).astype(np.int32)
    jcache = JT.init_cache(jcfg, B, max_seq)
    tcache = TT.init_cache(tcfg, B, max_seq, device="cpu")
    jl, jcache = _jax_prefill(jparams, jcfg, jcache,
                              jnp.asarray(toks[:, :prompt]))
    tl, tcache = TT.lm_prefill(
        tparams, {"tokens": torch.from_numpy(toks[:, :prompt])}, tcfg, tcache)
    _assert_close(tl, jl, **tol)
    _assert_cache_close(jcache, tcache, rel)
    for t in range(prompt, prompt + 6):
        pos = np.full((B, 1), t, np.int32)
        tok = toks[:, t:t + 1]
        jl, jcache = _jax_decode(jparams, jcfg, jcache, jnp.asarray(tok),
                                 jnp.asarray(pos))
        tl, tcache = TT.lm_decode_step(tparams, torch.from_numpy(tok),
                                       torch.from_numpy(pos), tcfg, tcache)
        _assert_close(tl, jl, **tol)
    _assert_cache_close(jcache, tcache, rel)
    pos = np.broadcast_to(np.arange(prompt + 6, prompt + 11, dtype=np.int32),
                          (B, 5)).copy()
    jl, jcache = _jax_append(jparams, jcfg, jcache,
                             jnp.asarray(toks[:, prompt + 6:]),
                             jnp.asarray(pos))
    tl, tcache = TT.lm_append(tparams, torch.from_numpy(toks[:, prompt + 6:]),
                              torch.from_numpy(pos), tcfg, tcache)
    _assert_close(tl, jl, **tol)
    _assert_cache_close(jcache, tcache, rel)


def test_cache_from_jax_continues_in_the_port():
    """The JAX package's cache after a prefill (tuples of float32 leaves),
    carried across by ``tree_from_jax``, decodes in the port as it does in
    the JAX package."""
    jcfg, jparams, tcfg, tparams = _models("float32")
    B = 2
    toks = np.random.default_rng(13).integers(
        0, jcfg.vocab_size, (B, 18)).astype(np.int32)
    _, jcache = _jax_prefill(jparams, jcfg, JT.init_cache(jcfg, B, 32),
                             jnp.asarray(toks[:, :14]))
    tcache = tree_from_jax(jax.tree.map(np.asarray, jcache), "cpu")
    assert isinstance(tcache["b0"], tuple) and isinstance(tcache["b7"],
                                                          tuple)
    _assert_cache_close(jcache, tcache, 0.0)
    for t in range(14, 18):
        pos = np.full((B, 1), t, np.int32)
        jl, jcache = _jax_decode(jparams, jcfg, jcache,
                                 jnp.asarray(toks[:, t:t + 1]),
                                 jnp.asarray(pos))
        tl, tcache = TT.lm_decode_step(
            tparams, torch.from_numpy(toks[:, t:t + 1]),
            torch.from_numpy(pos), tcfg, tcache)
        _assert_close(tl, jl, **TOL_MODEL)
    _assert_cache_close(jcache, tcache, TOL_STATE["rel"])


def test_xlstm_config_matches_jax():
    for get in ("get_config", "get_smoke"):
        j = getattr(jconfigs, get)("xlstm_350m")
        t = getattr(tconfigs, get)("xlstm_350m")
        for f in dataclasses.fields(tconfig.ModelConfig):
            a, b = getattr(j, f.name), getattr(t, f.name)
            if f.name == "pattern":
                a = tuple((m.value, n.value) for m, n in a)
                b = tuple((m.value, n.value) for m, n in b)
            assert a == b, f.name
        assert t.param_count() == j.param_count()
    full = tconfigs.get_config("xlstm_350m")
    assert (full.num_layers, full.d_model, full.num_heads, full.padded_vocab,
            full.num_groups) == (24, 1024, 4, 51200, 3)
    TT.check_ported(full)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_train_cli_xlstm_smoke(tmp_path, capsys):
    assert ttrain.main(["--arch", "xlstm_350m", "--smoke", "--device", "cpu",
                        "--steps", "3", "--batch", "2", "--seq", "32",
                        "--registry", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    loss = float(out.split("[train] done; final loss")[1].split()[0])
    assert np.isfinite(loss)
    assert "[train] step     0 loss" in out


def test_serve_cli_xlstm_smoke(capsys):
    assert tserve.main(["--arch", "xlstm_350m", "--smoke", "--device", "cpu",
                        "--requests", "3", "--decode-steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "[serve] prefill 32 tokens x 3 requests" in out
    assert "[serve] decoded 4 steps x 3 requests" in out
