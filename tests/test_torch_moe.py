"""The port's MoE slice against the JAX package, on the CPU, and
``init_lm``'s parallel draw.

granite_moe_1b_a400m (32 experts, top-8, in every layer) and
llama4_maverick_400b_a17b (128 experts, top-1, with a shared expert, every
other layer) at their smoke sizes.  Inputs are made from a seed with
numpy and handed to both packages; the MoE layers run the weights of the
reference's ``moe.init_moe`` and the models those of ``T.init_lm(
jax.random.PRNGKey(0), cfg)``, through ``tree_from_jax``.
"""
import contextlib
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.convert import tree_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcommon
from repro_torch.models import config as tconfig
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT
from repro_torch.tree import flatten, leaves, unflatten

MOE = ("granite_moe_1b_a400m", "llama4_maverick_400b_a17b")
# the tolerances of test_torch_dense.py.  float32: XLA and torch sum
# matmuls and softmaxes in other orders (measured here: MoE outputs and
# logits at most 1e-6 apart, relative L2)
TOL_MODEL = dict(rtol=1e-4, atol=1e-5, rel_l2=1e-5)
# bfloat16: the two frameworks round bf16 intermediates at other places;
# the bound is on the relative L2 error, with a loose elementwise bound
TOL_MODEL_BF16 = dict(rtol=1e-1, atol=2.5e-1, rel_l2=5e-2)
# float32 gradients of lm_loss (test_torch_train.py's GRAD_TOL)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


class _Routing:
    """The JAX run's expert picks, for the port's run to follow (bf16).

    In bf16 two router logits one rounding apart can swap an expert pick,
    and a swapped pick changes the token's output wholesale: in llama4's
    smoke prefill experts 1 and 2 tie at 0.16015625 in the JAX run, the
    port rounds expert 2's logit to 0.16113281 and picks it, and the
    logits lie 0.28 apart (relative L2).  So in bf16 the JAX package runs
    op by op (``jax.disable_jit``; jitted, XLA fuses bf16 chains and
    rounds them once, and its own jitted and eager runs of llama4's smoke
    forward pick other experts for one of 48 tokens, 0.29 apart), its
    picks are recorded in call order, and the port's run takes them.
    Each pick of the port's own that differs must be a near-tie in the
    JAX run's bf16 logits: within ``TIE`` (two bf16 ulps, relative) of
    the pick it replaces.  float32 runs are compared as they are,
    jitted."""

    TIE = 2.0 ** -6

    def __init__(self, dtype):
        self.on = dtype != "float32"
        self.picks = []  # (ids, logits) of each JAX router call
        self.swapped = 0

    def reference(self, fn):
        """``fn`` jitted (float32), or op by op recording its picks."""
        if not self.on:
            return jax.jit(fn, static_argnames=("cfg",))
        plain = jmoe._router

        def recording(params, xf, cfg):
            out = plain(params, xf, cfg)
            router = jmoe.value_of(params["router"]).astype(xf.dtype)
            self.picks.append((np.asarray(out[1]),
                               np.asarray((xf @ router).astype(jnp.float32))))
            return out

        def run(*args, **kw):
            with jax.disable_jit(), mock.patch.object(jmoe, "_router",
                                                      recording):
                return fn(*args, **kw)

        return run

    @contextlib.contextmanager
    def port(self):
        """The port's run, taking the recorded picks in order."""
        if not self.on:
            yield
            return
        plain = tmoe.top_k

        def following(probs, k):
            own = plain(probs, k)[1].numpy()
            ids, logits = self.picks.pop(0)
            for at in map(tuple, np.argwhere(own != ids)):
                a, b = logits[at[:-1]][ids[at]], logits[at[:-1]][own[at]]
                assert abs(a - b) <= self.TIE * max(abs(a), abs(b)), (
                    "the port picks another expert where the JAX run's "
                    "bf16 logits are no near-tie", at, a, b)
                self.swapped += 1
            ids = torch.from_numpy(ids.copy()).long()
            return torch.gather(probs, -1, ids), ids

        with mock.patch.object(tmoe, "top_k", following):
            yield
        assert not self.picks


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


def _cfgs(arch, dtype="float32", **kw):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype=dtype, **kw)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype=dtype, **kw)
    return jcfg, tcfg


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors: torch's intra-op threads cost more than they save
    beside the suite's other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# configs, capacity, router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
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
        for active in (False, True):
            assert t.param_count(active) == j.param_count(active)


def test_granite_param_counts():
    cfg = tconfigs.get_config("granite_moe_1b_a400m")
    assert cfg.param_count() == 1_334_627_328
    assert cfg.param_count(active=True) == 428_657_664
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.num_experts,
            cfg.num_experts_per_tok, cfg.padded_vocab) == (
        24, 1024, 16, 8, 64, 512, 32, 8, 51_200)


@pytest.mark.parametrize("cf", [0.25, 1.0, 1.25, 2.0, 8.0])
@pytest.mark.parametrize("arch", MOE)
def test_expert_capacity_matches_jax(arch, cf):
    for cfg_of in (jconfigs.get_config, jconfigs.get_smoke):
        jcfg = dataclasses.replace(cfg_of(arch), capacity_factor=cf)
        tcfg = dataclasses.replace(
            getattr(tconfigs, cfg_of.__name__)(arch), capacity_factor=cf)
        for tokens in (1, 7, 8, 9, 31, 32, 33, 100, 256, 1000, 4096):
            c = tmoe.expert_capacity(tcfg, tokens)
            assert c == jmoe.expert_capacity(jcfg, tokens)
            assert c >= 8 and c % 8 == 0


def _moe_params(jcfg, seed=1):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, tree_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    return jx, torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("arch", MOE)
def test_router_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _moe_params(jcfg)
    jx, tx = _x((2, 16, jcfg.d_model), 3, "float32")
    jw, jids, jaux = jmoe._router(jp, jx, jcfg)
    tw, tids, taux = tmoe._router(tp, tx, tcfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("arch", MOE)
def test_router_ties_take_the_lower_index(arch):
    """Equal logits (duplicated router columns, and all-zero rows of x)
    pick experts in index order, as ``jax.lax.top_k`` does."""
    jcfg, tcfg = _cfgs(arch, num_experts=8, num_experts_per_tok=3)
    jp, tp = _moe_params(jcfg)
    r = np.asarray(jp["router"].value if hasattr(jp["router"], "value")
                   else jp["router"]).copy()
    r[:, 5] = r[:, 2]
    r[:, 6] = r[:, 2]
    r[:, 7] = r[:, 1]
    x = np.random.default_rng(4).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)
    x[0, :4] = 0.0  # every logit 0: experts 0, 1, 2
    jw, jids, _ = jmoe._router({"router": jnp.asarray(r)}, jnp.asarray(x),
                               jcfg)
    tw, tids, _ = tmoe._router({"router": torch.from_numpy(r)},
                               torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    assert tids[0, :4].tolist() == [[0, 1, 2]] * 4
    ids = tids.reshape(-1, 3)
    # a duplicated column never comes before its original
    for a, b in ((2, 5), (2, 6), (5, 6), (1, 7)):
        for row in ids.tolist():
            if a in row and b in row:
                assert row.index(a) < row.index(b)
    assert torch.equal(tmoe.top_k(torch.tensor([[1.0, 3.0, 3.0, 1.0, 3.0]]),
                                  4)[1], torch.tensor([[1, 2, 4, 0]]))


# ---------------------------------------------------------------------------
# moe_forward: both routes, with and without drops
# ---------------------------------------------------------------------------

def _layer_tol(dtype, want):
    """An MoE layer's outputs reach |y| ~ 150 at the smoke sizes (the
    expert stacks are scaled by 1/sqrt(E), not 1/sqrt(d), as in the
    reference): in bf16 the elementwise bound is two bf16 ulps of the
    largest output (measured: 1 ulp, 1.0 at 155, and relative L2 4.1e-3
    at most), beside TOL_MODEL_BF16's relative L2 bound."""
    if dtype == "float32":
        return TOL_MODEL
    return dict(TOL_MODEL_BF16, atol=2.0 ** -6 * float(np.abs(_f32(want)).max()))


def _dropped(tcfg, ids):
    """(token, k) entries past capacity on the local route, from the
    router's picks ``ids`` [B,S,K]."""
    B, S, _ = ids.shape
    counts = torch.nn.functional.one_hot(
        ids.reshape(B, -1), tcfg.num_experts).sum(1)
    C = tmoe.expert_capacity(tcfg, S)
    return int(torch.clamp(counts - C, min=0).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [0.25, 8.0], ids=["drops", "dropless"])
@pytest.mark.parametrize("route", ["local", "global"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_matches_jax(arch, route, cf, dtype):
    jcfg, tcfg = _cfgs(arch, dtype, capacity_factor=cf, moe_routing=route)
    jp, tp = _moe_params(jcfg)
    # 48 tokens a row: capacity 8 drops at cf 0.25 for both configs
    jx, tx = _x((2, 48, jcfg.d_model), 5, dtype)
    jout, jaux = _Routing(dtype).reference(jmoe.moe_forward)(jp, jx,
                                                             cfg=jcfg)
    tout, taux = tmoe.moe_forward(tp, tx, tcfg)
    assert tout.dtype == getattr(torch, dtype)
    assert tout.shape == tx.shape
    _assert_close(tout, jout, **_layer_tol(dtype, jout))
    np.testing.assert_allclose(float(taux), float(jaux),
                               rtol=1e-5 if dtype == "float32" else 2e-2)
    if route == "local":
        ids = tmoe._router(tp, tx, tcfg)[1]
        assert (_dropped(tcfg, ids) > 0) == (cf < 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_local_routing_matches_global_dropless(arch, dtype):
    """The port's scatter-free local route equals its global route at
    dropless capacity (the reference's test_models.py holds its own pair
    to rtol 1e-5, atol 1e-6 in float32)."""
    _, tcfg = _cfgs(arch, dtype, capacity_factor=8.0)
    _, tp = _moe_params(_cfgs(arch, dtype)[0], seed=0)
    _, tx = _x((2, 16, tcfg.d_model), 1, dtype)
    tx = tx * 0.1
    out_l, aux_l = tmoe.moe_forward(
        tp, tx, dataclasses.replace(tcfg, moe_routing="local"))
    out_g, aux_g = tmoe.moe_forward(
        tp, tx, dataclasses.replace(tcfg, moe_routing="global"))
    if dtype == "float32":
        np.testing.assert_allclose(out_l.numpy(), out_g.numpy(), rtol=1e-5,
                                   atol=1e-6)
    else:
        _assert_close(out_l, out_g, **TOL_MODEL_BF16)
    assert abs(float(aux_l) - float(aux_g)) < 1e-6


@pytest.mark.parametrize("route", ["local", "global"])
def test_moe_forward_same_bits_twice(route):
    _, tcfg = _cfgs("granite_moe_1b_a400m", capacity_factor=0.5,
                    moe_routing=route)
    _, tp = _moe_params(_cfgs("granite_moe_1b_a400m")[0])
    _, tx = _x((2, 40, tcfg.d_model), 6, "float32")
    a, b = (tmoe.moe_forward(tp, tx, tcfg)[0] for _ in range(2))
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the models: forward, loss and gradients, serving
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(arch, dtype, cf=1.25):
    jcfg, tcfg = _cfgs(arch, dtype, capacity_factor=cf)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = tree_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("arch", MOE)
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
    names = jax.tree_util.keystr(jflat[0][0]), [
        jax.tree_util.keystr(p) for p, _ in jflat]
    assert any("['moe']['w_down']" in n for n in names[1])
    _assert_trees_close(JT.init_cache(jcfg, 2, 32),
                        TT.init_cache(tcfg, 2, 32, device="cpu"),
                        rtol=0, atol=0, rel_l2=0)


def _jax_forward(params, tokens, cfg):
    return JT.lm_forward(params, {"tokens": tokens}, cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_lm_forward_matches_jax(arch, dtype):
    jcfg, jparams, tcfg, tparams = _models(arch, dtype)
    toks = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    routing = _Routing(dtype)
    want, jaux = routing.reference(_jax_forward)(jparams, jnp.asarray(toks),
                                                 cfg=jcfg)
    with routing.port():
        got, taux = TT.lm_forward(tparams,
                                  {"tokens": torch.from_numpy(toks)}, tcfg)
    assert got.dtype == torch.float32
    _assert_close(got, want, **_tol(dtype))
    assert float(jaux) > 0
    np.testing.assert_allclose(float(taux), float(jaux),
                               rtol=1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("arch", MOE)
def test_lm_loss_and_grads_match_jax(arch):
    """float32: xent, the MoE aux (summed over layers) and the loss with
    ``router_aux_coef``, and every gradient leaf, through the gathers'
    backward on the CPU."""
    jcfg, jparams, tcfg, tparams = _models(arch, "float32")
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    labels[0, :3] = -1
    batch = {"tokens": toks, "labels": labels}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JT.lm_loss(p, jax.tree.map(jnp.asarray, batch), jcfg),
        has_aux=True)(jparams)
    flat, treedef = flatten(tparams)
    flat = [t.detach().clone().requires_grad_(True) for t in flat]
    tl, tm = TT.lm_loss(unflatten(treedef, flat),
                        {k: torch.from_numpy(v) for k, v in batch.items()},
                        tcfg)
    tg = torch.autograd.grad(tl, flat)
    tl, tm = tl.detach(), {k: v.detach() for k, v in tm.items()}
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["xent"]), float(jm["xent"]),
                               rtol=1e-5)
    assert float(jm["aux"]) > 0
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-5)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for t, j in zip(tg, jleaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **GRAD_TOL)


def _jax_prefill(params, cache, tokens, cfg):
    return JT.lm_prefill(params, {"tokens": tokens}, cfg, cache)


def _jax_decode(params, cache, tokens, positions, cfg):
    return JT.lm_decode_step(params, tokens, positions, cfg, cache)


def _jax_append(params, cache, tokens, positions, cfg):
    return JT.lm_append(params, tokens, positions, cfg, cache)


@pytest.mark.parametrize("dtype,cf", [("float32", 1.25), ("bfloat16", 1.25),
                                      ("float32", 0.5)])
@pytest.mark.parametrize("arch", MOE)
def test_serving_calls_match_jax(arch, dtype, cf):
    """A 24-token prefill (at capacity factor 0.5 some entries drop), 8
    decode steps (S = 1: capacity 8, nothing drops) and a 6-token append
    held against the JAX package's ``lm_append`` (an append drops as a
    prefill does, which is the reference's behaviour): logits and every
    cache leaf after each call."""
    jcfg, jparams, tcfg, tparams = _models(arch, dtype, cf)
    tol = _tol(dtype)
    routing = _Routing(dtype)
    B, max_seq, prompt = 2, 48, 24
    rng = np.random.default_rng(12)
    toks = rng.integers(0, jcfg.vocab_size, (B, prompt + 14)).astype(np.int32)
    jcache = JT.init_cache(jcfg, B, max_seq)
    tcache = TT.init_cache(tcfg, B, max_seq, device="cpu")
    jl, jcache = routing.reference(_jax_prefill)(
        jparams, jcache, jnp.asarray(toks[:, :prompt]), cfg=jcfg)
    with routing.port():
        tl, tcache = TT.lm_prefill(
            tparams, {"tokens": torch.from_numpy(toks[:, :prompt])}, tcfg,
            tcache)
    _assert_close(tl, jl, **tol)
    _assert_trees_close(jcache, tcache, **tol)
    for t in range(prompt, prompt + 8):
        pos = np.full((B, 1), t, np.int32)
        tok = toks[:, t:t + 1]
        jl, jcache = routing.reference(_jax_decode)(
            jparams, jcache, jnp.asarray(tok), jnp.asarray(pos), cfg=jcfg)
        with routing.port():
            tl, tcache = TT.lm_decode_step(tparams, torch.from_numpy(tok),
                                           torch.from_numpy(pos), tcfg,
                                           tcache)
        _assert_close(tl, jl, **tol)
    _assert_trees_close(jcache, tcache, **tol)
    pos = np.broadcast_to(np.arange(prompt + 8, prompt + 14, dtype=np.int32),
                          (B, 6)).copy()
    jl, jcache = routing.reference(_jax_append)(
        jparams, jcache, jnp.asarray(toks[:, prompt + 8:]), jnp.asarray(pos),
        cfg=jcfg)
    with routing.port():
        tl, tcache = TT.lm_append(tparams,
                                  torch.from_numpy(toks[:, prompt + 8:]),
                                  torch.from_numpy(pos), tcfg, tcache)
    _assert_close(tl, jl, **tol)
    _assert_trees_close(jcache, tcache, **tol)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_drops_at_half_capacity(arch):
    """The half-capacity serving test reaches the drop path: its prefill
    sends more (token, k) entries to some expert than the row's
    capacity of 8 in every MoE layer."""
    _, _, tcfg, tparams = _models(arch, "float32", 0.5)
    toks = torch.from_numpy(np.random.default_rng(12).integers(
        0, tcfg.vocab_size, (2, 24)).astype(np.int32))
    drops, plain = [], tmoe._router

    def counting(params, x, cfg):
        out = plain(params, x, cfg)
        drops.append(_dropped(cfg, out[1]))
        return out

    with mock.patch.object(tmoe, "_router", counting):
        TT.lm_prefill(tparams, {"tokens": toks}, tcfg,
                      TT.init_cache(tcfg, 2, 48, device="cpu"))
    assert tmoe.expert_capacity(tcfg, 24) == 8
    assert len(drops) == tcfg.num_layers // len(tcfg.pattern) * sum(
        f == tconfig.BlockKind.MOE for _, f in tcfg.pattern)
    assert all(d > 0 for d in drops), drops


@pytest.mark.parametrize("arch", MOE)
def test_serve_cli_smoke(arch, capsys):
    assert tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--decode-steps", "4"]) == 0
    out = capsys.readouterr().out
    for line in ("[serve] prefill 32 tokens x 8 requests: ",
                 "[serve] decoded 4 steps x 8 requests: ",
                 "[serve] sample continuation (request 0): "):
        assert line in out


# ---------------------------------------------------------------------------
# init_lm: the parallel draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_init_lm_same_bits_for_any_thread_count(arch):
    """One seed, the same bits drawn on 1, 3 and 8 threads (torch's
    intra-op thread count) and for two calls; another seed other bits."""
    cfg = tconfigs.get_smoke(arch)
    want = leaves(TT.init_lm(cfg, seed=5, device="cpu"))
    for threads in (3, 8, 8):
        torch.set_num_threads(threads)
        got = leaves(TT.init_lm(cfg, seed=5, device="cpu"))
        assert torch.get_num_threads() == threads
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    other = leaves(TT.init_lm(cfg, seed=6, device="cpu"))
    assert not any(torch.equal(o, w) for o, w in zip(other, want)
                   if w.abs().max() > 0)


def test_draw_blocks_same_bits_for_any_thread_count():
    """A leaf of several blocks (the last one short), drawn on 1 and 4
    threads and into a float64 tensor (through the host buffer) gives the
    same values; truncated normal on [-2, 2] times its scale."""
    leaf = tcommon.param((3 * tcommon.BLOCK // 1000 + 7, 1000))
    a = tcommon.materialize(leaf, 9, "w")
    torch.set_num_threads(4)
    b = tcommon.materialize(leaf, 9, "w")
    assert torch.equal(a, b)
    c = torch.empty(leaf.shape, dtype=torch.float64)
    tcommon.draw(9, [("w", leaf, c)])
    assert torch.equal(c.float(), a)
    z = a / leaf.scale
    assert float(z.abs().max()) <= 2.0
    assert abs(float(z.mean())) < 5e-3
    # the std of a standard normal truncated to [-2, 2]
    assert abs(float(z.std()) - 0.8796) < 2e-3
    blocks = a.view(-1).split(tcommon.BLOCK)
    assert len(blocks) == 4 and not torch.equal(blocks[0][:100],
                                                blocks[1][:100])
