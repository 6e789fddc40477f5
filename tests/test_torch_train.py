"""The port's training slice against the JAX package, on the CPU.

Both packages start from the reference's weights (``T.init_lm`` with
``PRNGKey(0)``) and, where an optimizer state is needed, the reference's
AdamW state, both handed over through ``tree_from_jax``; batches come
from the numpy data pipeline, which both packages share bit for bit.  Attention runs the flash
kernel's plain version here (``ops.attention`` on CPU tensors).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokenDataset as JDataset
from repro.data import make_train_iterator as jmake_train_iterator
from repro.models import common as jcommon
from repro.models import transformer as JT
from repro.models.common import split_params
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.convert import tree_from_jax
from repro_torch.data import DataConfig, SyntheticTokenDataset, make_train_iterator
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedule as tschedule
from repro_torch.train import step as tstep
from repro_torch.tree import flatten, leaves, unflatten

# float32: XLA and torch sum matmuls and softmaxes in other orders
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# bfloat16 compute (smollm's own dtype): activations round to bf16 after
# every product, at other places in the two frameworks' graphs, and one
# flipped last bit (2^-8 relative) propagates.  Measured on the CPU for
# smollm's smoke config: loss 2.0e-5 relative, every gradient leaf within
# 1.4 % of its largest entry; the bounds keep a 2-10x margin
BF16_LOSS_TOL = dict(rtol=2e-4, atol=0)
BF16_GRAD_REL = 3e-2
# deeper smoke models in bf16 (13 and 17 layers) carry the rounding
# differences further: measured on the CPU, every gradient leaf within
# 15.9 % (recurrentgemma_2b) and 11.0 % (gemma3_4b) of its largest entry,
# 9.8 % and 7.2 % in relative L2; chatglm3_6b (2 layers) within 1.7 %.
# The bounds keep about 2x room
BF16_GRAD_REL_BY_ARCH = {"recurrentgemma_2b": 0.3, "gemma3_4b": 0.25}
# a few optimizer steps: Adam divides each entry's update by its own
# gradient scale, so an entry whose gradient is near 0 (|g| ~ eps) turns
# the gradients' last-bit differences into a visible part of lr (up to
# 8.3e-6 measured, against lr = 1e-3): atol is 2 % of one step's lr
STEP_TOL = dict(rtol=1e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: torch's intra-op threads cost more than
    they save, and beside other test processes they oversubscribe the
    cores (the suite runs files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(arch, dtype=None):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    if dtype:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        tcfg = dataclasses.replace(tcfg, dtype=dtype)
    jparams, _ = split_params(JT.init_lm(jax.random.PRNGKey(0), jcfg))
    return jcfg, jparams, tcfg, tree_from_jax(_np(jparams), "cpu")


def _batch(cfg, B=2, S=24, seed=0, masked=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if masked:
        labels[0, :3] = -1  # masked positions
    return {"tokens": tokens, "labels": labels}


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _loss_and_grads(params, batch, cfg, remat="none"):
    flat, treedef = flatten(params)
    inputs = [p.detach().clone().requires_grad_() for p in flat]
    loss, metrics = TT.lm_loss(unflatten(treedef, inputs), batch, cfg,
                               remat=remat)
    return loss, metrics, torch.autograd.grad(loss, inputs)


def _assert_tree_close(ttree, jtree, **tol):
    tl, jl = leaves(ttree), jax.tree.leaves(jtree)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32), **tol)


# ---------------------------------------------------------------------------
# the two faults repaired with this slice
# ---------------------------------------------------------------------------

def test_embed_bf16_bit_equal_to_reference():
    jcfg = jconfigs.get_config("smollm_360m")  # bfloat16, d_model 960
    tcfg = tconfigs.get_config("smollm_360m")
    rng = np.random.default_rng(0)
    table = rng.standard_normal((64, jcfg.d_model)).astype(np.float32)
    ids = rng.integers(0, 64, (4, 16)).astype(np.int32)
    want = jcommon.embed({"table": jnp.asarray(table)}, jnp.asarray(ids), jcfg)
    got = tcommon.embed({"table": torch.from_numpy(table)},
                        torch.from_numpy(ids), tcfg)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def test_logits_accumulate_in_float32():
    jcfg = jconfigs.get_config("smollm_360m")
    tcfg = tconfigs.get_config("smollm_360m")
    rng = np.random.default_rng(1)
    table = (0.02 * rng.standard_normal((256, jcfg.d_model))).astype(np.float32)
    norm = (0.1 * rng.standard_normal(jcfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
    jparams = {"embed": {"table": jnp.asarray(table)},
               "final_norm": jnp.asarray(norm)}
    want = JT._logits(jparams, jnp.asarray(x).astype(jnp.bfloat16), jcfg)
    got = TT._logits(tree_from_jax(_np(jparams), "cpu"),
                     torch.from_numpy(x).to(torch.bfloat16), tcfg)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# data pipeline, schedule, optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,host,hosts", [
    (0, 0, 0, 1), (0, 7, 0, 1), (3, 11, 1, 2), (5, 123, 3, 4)])
def test_data_batches_bit_identical(seed, step, host, hosts):
    kw = dict(vocab_size=2048, seq_len=32, global_batch=8, seed=seed)
    want = JDataset(JDataConfig(**kw)).batch(step, host_id=host,
                                             num_hosts=hosts)
    got = SyntheticTokenDataset(DataConfig(**kw)).batch(
        step, host_id=host, num_hosts=hosts)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_train_iterator_matches_reference():
    kw = dict(vocab_size=512, seq_len=16, global_batch=4, seed=2)
    jit, tit = (jmake_train_iterator(JDataConfig(**kw), start_step=5),
                make_train_iterator(DataConfig(**kw), start_step=5))
    try:
        for _ in range(3):
            (js, jb), (ts, tb) = next(jit), next(tit)
            assert js == ts
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k])
    finally:
        jit.close()
        tit.close()


def test_cosine_schedule_equal_over_200_steps():
    kw = dict(peak=3e-3, warmup_steps=10, total_steps=200)
    steps = np.arange(201, dtype=np.int32)
    want = np.asarray(jschedule.cosine_schedule(jnp.asarray(steps), **kw))
    got = tschedule.cosine_schedule(torch.from_numpy(steps), **kw).numpy()
    assert got.dtype == np.float32
    # warmup: the same float32 operations, bit for bit.  After it, XLA's
    # and torch's float32 cos differ by one ulp on a few arguments (8 of
    # 201 here, for the same float32 input); through 0.1 + 0.45 * (1 + cos)
    # that is at most peak * 0.45 * 2^-23 in lr, plus the final rounding
    # to float32 (one ulp of lr, 2^-23 relative)
    np.testing.assert_array_equal(got[:10], want[:10])
    np.testing.assert_allclose(got, want, rtol=2.0 ** -23,
                               atol=kw["peak"] * 0.45 * 2.0 ** -23)
    for s in (0, 9, 10, 57, 200):  # one step at a time, as the train step
        one = tschedule.cosine_schedule(torch.tensor(s, dtype=torch.int32),
                                        **kw)
        assert float(one) == float(got[s])
    np.testing.assert_array_equal(
        tschedule.linear_warmup(torch.from_numpy(steps), 10, 3e-3).numpy(),
        np.asarray(jschedule.linear_warmup(jnp.asarray(steps), 10, 3e-3)))


@pytest.mark.parametrize("factored", [False, True])
def test_adamw_update_matches_reference(factored):
    rng = np.random.default_rng(3)
    shapes = {"a": (256, 128), "b": (3, 128, 160), "c": (7,),
              "d": {"e": (130, 5)}}

    def draw(scale):
        def go(s):
            if isinstance(s, dict):
                return {k: go(v) for k, v in s.items()}
            return (scale * rng.standard_normal(s)).astype(np.float32)
        return go(shapes)

    params, g1, g2 = draw(1.0), draw(0.3), draw(0.01)
    kw = dict(factored=factored, weight_decay=0.1, clip_norm=1.0)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadamw.adamw_init(jp, jcfg)
    tp = tree_from_jax(params, "cpu")
    ts = tadamw.adamw_init(tp, tcfg)
    assert [tuple(x.shape) for x in leaves(ts)] == \
        [x.shape for x in jax.tree.leaves(js)]
    for g, lr in ((g1, 1e-3), (g2, 3e-4)):
        jp, js, jm = jadamw.adamw_update(
            jp, jax.tree.map(jnp.asarray, g), js, jcfg, lr=jnp.float32(lr))
        tp, ts, tm = tadamw.adamw_update(
            tp, tree_from_jax(g, "cpu"), ts, tcfg,
            lr=torch.tensor(lr, dtype=torch.float32))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts["count"]) == int(js["count"]) == 2
    assert ts["count"].dtype == torch.int32
    _assert_tree_close(tp, jp, rtol=1e-5, atol=1e-7)
    _assert_tree_close(ts, js, rtol=1e-5, atol=1e-9)


# ---------------------------------------------------------------------------
# model: loss, gradients, prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,dtype", [
    ("paper_consumer", None), ("smollm_360m", None),
    ("smollm_360m", "bfloat16"),
    # the RG-LRU's plain backward and the local-attention ring; gemma3's
    # QK-norm, softcap and local/global pattern; chatglm3's partial RoPE
    ("recurrentgemma_2b", "float32"), ("recurrentgemma_2b", "bfloat16"),
    ("gemma3_4b", "float32"), ("gemma3_4b", "bfloat16"),
    ("chatglm3_6b", "float32"), ("chatglm3_6b", "bfloat16")])
def test_lm_loss_and_grads_match_reference(arch, dtype):
    jcfg, jparams, tcfg, tparams = _models(arch, dtype)
    b = _batch(jcfg)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JT.lm_loss(p, jax.tree.map(jnp.asarray, b), jcfg),
        has_aux=True)(jparams)
    tl, tm, tg = _loss_and_grads(tparams, _torch_batch(b), tcfg)
    tl = tl.detach()
    tm = {k: m.detach() for k, m in tm.items()}
    assert float(tm["tokens"]) == float(jm["tokens"]) == 45.0
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    tg = unflatten(flatten(tparams)[1], list(tg))
    if dtype == "bfloat16":
        np.testing.assert_allclose(float(tl), float(jl), **BF16_LOSS_TOL)
        for t, j in zip(leaves(tg), jax.tree.leaves(jg)):
            j = np.asarray(j, np.float32)
            err = np.abs(t.numpy() - j).max()
            rel = BF16_GRAD_REL_BY_ARCH.get(arch, BF16_GRAD_REL)
            assert err <= rel * np.abs(j).max(), (err, j.shape)
        return
    np.testing.assert_allclose(float(tl), float(jl), **LOSS_TOL)
    np.testing.assert_allclose(float(tm["xent"]), float(jm["xent"]),
                               **LOSS_TOL)
    _assert_tree_close(tg, jg, **GRAD_TOL)


def test_remat_recomputes_the_same_bits():
    _, _, tcfg, tparams = _models("smollm_360m")
    b = _torch_batch(_batch(tcfg))
    l0, _, g0 = _loss_and_grads(tparams, b, tcfg, remat="none")
    for remat in ("full", "dots"):
        l1, _, g1 = _loss_and_grads(tparams, b, tcfg, remat=remat)
        assert torch.equal(l0, l1)
        assert all(torch.equal(x, y) for x, y in zip(g0, g1))
    with pytest.raises(ValueError, match="remat"):
        _loss_and_grads(tparams, b, tcfg, remat="some")


@pytest.mark.parametrize("arch,S,max_seq", [
    ("smollm_360m", 12, 32),     # prompt shorter than the cache
    ("paper_consumer", 40, 32),  # longer: the kept window is rolled
    ("paper_consumer", 64, 32),  # a multiple: no roll
])
def test_lm_prefill_matches_reference(arch, S, max_seq):
    jcfg, jparams, tcfg, tparams = _models(arch)
    tokens = _batch(jcfg, B=2, S=S)["tokens"]
    jlog, jcache = JT.lm_prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                 jcfg, JT.init_cache(jcfg, 2, max_seq))
    tcache = TT.init_cache(tcfg, 2, max_seq, device="cpu")
    tlog, out = TT.lm_prefill(tparams, {"tokens": torch.from_numpy(tokens)},
                              tcfg, tcache)
    assert out is tcache  # written in place
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=2e-4,
                               atol=2e-5)
    tl, jl = leaves(tcache), jax.tree.leaves(jcache)
    for t, j in zip(tl, jl):
        if t.dtype == torch.int32:  # slot positions: exact
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-4,
                                       atol=2e-5)
    pos = tcache["b0"]["pos"][0, 0]
    if S > max_seq:
        assert torch.equal(pos % max_seq, torch.arange(max_seq,
                                                       dtype=torch.int32))
    # decode continues from the prefilled cache as the reference does
    tok = np.argmax(np.asarray(jlog)[:, -1:], axis=-1).astype(np.int32)
    p = np.full((2, 1), S, np.int32)
    jl2, _ = JT.lm_decode_step(jparams, jnp.asarray(tok), jnp.asarray(p),
                               jcfg, jcache)
    tl2, _ = TT.lm_decode_step(tparams, torch.from_numpy(tok),
                               torch.from_numpy(p), tcfg, tcache)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=2e-4,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def _step_cfgs(microbatches=1):
    kw = dict(remat="none", lr_peak=1e-3, warmup_steps=2, total_steps=100,
              microbatches=microbatches)
    return (jstep.TrainStepConfig(opt=jadamw.AdamWConfig(weight_decay=0.01),
                                  **kw),
            tstep.TrainStepConfig(opt=tadamw.AdamWConfig(weight_decay=0.01),
                                  **kw))


def _run_steps(arch, n, microbatches=1):
    jcfg, jparams, tcfg, tparams = _models(arch)
    js_cfg, ts_cfg = _step_cfgs(microbatches)
    jfn = jax.jit(jstep.build_train_step(jcfg, js_cfg))
    tfn = tstep.build_train_step(tcfg, ts_cfg)
    jopt = jadamw.adamw_init(jparams, js_cfg.opt)
    topt = tree_from_jax(_np(jopt), "cpu")
    ds = JDataset(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                              global_batch=4))
    for s in range(n):
        b = ds.batch(s)
        if jcfg.frontend == "audio_frames":
            # the data pipeline makes tokens and labels only: stub audio
            # frames from the step, as chip_smoke.py's train-whisper does
            b["frames"] = np.random.default_rng([0, s]).normal(
                0, 0.02, (4, jcfg.encoder_seq, jcfg.d_model)).astype(
                    np.float32)
        jparams, jopt, jm = jfn(jparams, jopt, jax.tree.map(jnp.asarray, b),
                                jnp.asarray(s, jnp.int32))
        tparams, topt, tm = tfn(tparams, topt, _torch_batch(b),
                                torch.tensor(s, dtype=torch.int32))
        assert sorted(tm) == sorted(jm) == ["aux", "grad_norm", "loss",
                                            "lr", "tokens", "xent"]
        assert float(tm["lr"]) == float(jm["lr"])
        assert float(tm["tokens"]) == float(jm["tokens"])
        for k in ("loss", "xent", "grad_norm", "aux"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    return jparams, jopt, tparams, topt


# float32 smoke configs, one torch thread (the fixture).  Measured here:
# loss, xent, grad_norm and aux within 1.3e-6 relative at every step; the
# worst params or moment entry at 0.10 (paper_consumer), 0.81
# (recurrentgemma_2b: its tied embedding's near-zero gradients, 1.8e-5
# off at -0.022) and 0.13 (granite_moe_1b_a400m) of STEP_TOL's bound.
# granite's float32 expert picks are the reference's, as in
# tests/test_torch_moe.py's float32 cases: compared as they are, jitted.
# whisper_large_v3 (2 + 2 layers, 24 frames) adds the encoder, the
# cross-attention and dec_pos_embed to every step: its worst entry at
# 0.29 of the bound.
@pytest.mark.parametrize("arch", [
    "paper_consumer", "recurrentgemma_2b", "granite_moe_1b_a400m",
    "whisper_large_v3"])
def test_three_train_steps_match_reference(arch):
    jparams, jopt, tparams, topt = _run_steps(arch, 3)
    _assert_tree_close(tparams, jparams, **STEP_TOL)
    _assert_tree_close(topt, jopt, **STEP_TOL)
    assert int(topt["count"]) == 3


def test_microbatches_match_reference_and_one_batch():
    jparams, _, tparams, _ = _run_steps("smollm_360m", 2, microbatches=2)
    _assert_tree_close(tparams, jparams, **STEP_TOL)
    _, _, one, _ = _run_steps("smollm_360m", 2, microbatches=1)
    for a, b in zip(leaves(tparams), leaves(one)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **STEP_TOL)


def _chip_smoke():
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["paper_consumer", "granite_moe_1b_a400m"])
def test_gate_loss_terms_are_lm_loss(arch):
    """chip_smoke.py's float32 gradient gates read the loss through its
    per-token terms (``forward_and_backward``): the loss and every
    gradient bit-equal to ``transformer.lm_loss``'s, one term a kept
    token (the masked ones out), the terms' mean the loss, and that loss
    the reference's (granite's router aux term included)."""
    cs = _chip_smoke()
    jcfg, jparams, tcfg, tparams = _models(arch)
    batch = _batch(tcfg)
    loss, grads, terms = cs.forward_and_backward(
        tcfg, tparams, _torch_batch(batch), "none")
    want, _, want_grads = _loss_and_grads(tparams, _torch_batch(batch), tcfg)
    assert torch.equal(loss, want)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))
    assert terms.shape == (int((batch["labels"] >= 0).sum()),)
    assert not terms.requires_grad
    loss = float(loss.detach())
    np.testing.assert_allclose(float(terms.double().mean()), loss, rtol=1e-6)
    jloss, _ = JT.lm_loss(jparams, jax.tree.map(jnp.asarray, batch), jcfg)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
