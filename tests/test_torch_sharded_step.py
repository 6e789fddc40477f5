"""The port's step functions run sharded as DTensors, on 4 gloo ranks,
against the JAX package's unsharded steps.

One world of 4 ranks (``tests/torch_sharded_worker.py``, which imports
torch and the port only) runs every case on a 2 x 2 ``(data, model)``
mesh, and one on the multi-pod axes with a data axis of 1, as the mesh
``(pod, model)`` (batch and FSDP over ``("pod", "data")`` resolve to
``pod``); a world of one rank runs some on a 1 x 1
mesh and unsharded.  The worlds are spawned once for the module and meet
through file stores under ``tmp_path``.  Each case starts from the
reference's weights (``T.init_lm`` with ``PRNGKey(0)``) of a smoke config
in float32.  What is compared:

* one train step (AdamW from a fresh state): loss, grad norm, the
  gradients (the first moment after one step is 0.1 g), the updated
  params, against ``repro.train.step.build_train_step``;
* a prefill and 2 decode steps: the logits after each and every cache
  leaf, against ``T.lm_prefill`` and ``T.lm_decode_step``;
* two sharded runs give the same bits; a 1 x 1 mesh gives the unsharded
  port step's bits.
"""
import dataclasses
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.models.common import split_params
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.convert import tree_from_jax
from repro_torch.tree import flatten

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_sharded_worker.py")
SRC = os.path.join(HERE, "..", "src")

# the tolerances of tests/test_torch_train.py (float32: XLA and torch, and
# a sharded contraction's partial sums, add in other orders)
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=2e-5)
SERVE_TOL = dict(rtol=2e-4, atol=2e-5)  # test_lm_prefill_matches_reference
# AdamW's first step is lr g / (|g| + eps): at eps 1e-8 an entry whose
# gradient is near the rounding level turns a last-bit difference of g
# into a visible part of lr.  The unsharded port's step lies 3.06x, 24.1x
# and 3.13x STEP_TOL from the JAX package's (recurrentgemma, xlstm,
# gemma3 smoke models); at eps 1e-6, 0.37x and 0.06x for the first and
# last, so both packages step with eps 1e-6
ADAM_EPS = 1e-6
# xlstm_350m at norm_eps 1e-2, with tests/test_torch_xlstm.py's gradient
# bound there: within 5e-4 of each leaf's largest (and so its grad norm,
# which the unsharded port's step puts 2.5e-4 from the JAX package's).
# Readings of the unsharded port against the JAX package forced the rest:
# updated params 2.0e-4 apart (max abs, lr 1e-3), so 5e-4; cache leaves
# 2.96e-5 of their largest entry apart (sharded: 4.3e-5), so 1e-4
GRAD_TO_SCALE = {"xlstm_350m": 5e-4}
STATE_TO_SCALE = {"xlstm_350m": 1e-4}
STEP_ATOL = {"xlstm_350m": 5e-4}

ARCHS = ["paper_consumer", "smollm_360m", "recurrentgemma_2b", "xlstm_350m",
         "granite_moe_1b_a400m", "gemma3_4b", "whisper_large_v3",
         "qwen2_vl_72b"]
ONE_BY_ONE = ["smollm_360m", "recurrentgemma_2b", "granite_moe_1b_a400m"]
# two sharded runs of these (the kernels' custom backwards, the MoE plan)
# are held bit for bit
REPEAT = ["smollm_360m", "recurrentgemma_2b", "xlstm_350m",
          "granite_moe_1b_a400m"]
B, L, PROMPT, MAX_SEQ = 4, 16, 12, 32
WORLD_TIMEOUT = 400


def _inputs(cfg, seed=0):
    """A train batch, a prompt and 2 decode steps (numpy), with the stub
    frames, patches and [3,B,S] M-RoPE ids their frontends take."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    labels = np.roll(tok, -1, axis=1)
    labels[0, :3] = -1  # masked positions
    batch = {"tokens": tok, "labels": labels}
    prompt = {"tokens": np.ascontiguousarray(tok[:, :PROMPT])}
    if cfg.frontend == "audio_frames":
        fr = rng.normal(0, 0.02, (B, cfg.encoder_seq, cfg.d_model))
        batch["frames"] = prompt["frames"] = fr.astype(np.float32)
    if cfg.frontend == "image_patches":
        pe = rng.normal(0, 0.02, (B, cfg.num_patches, cfg.d_model))
        batch["patch_embeds"] = prompt["patch_embeds"] = pe.astype(np.float32)
        ids = np.broadcast_to(np.arange(L, dtype=np.int32), (3, B, L))
        batch["positions"] = np.ascontiguousarray(ids)
        prompt["positions"] = np.ascontiguousarray(ids[:, :, :PROMPT])
    decode = [{"tokens": np.ascontiguousarray(tok[:, PROMPT + i:PROMPT + i + 1]),
               "positions": np.full((B, 1), PROMPT + i, np.int32)}
              for i in range(2)]
    return batch, prompt, decode


def _torch(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in tree.items()}


# the xLSTM's float32 logits are ill-conditioned at its norm_eps 1e-6
# (the per-head norm of the mLSTM output; tests/test_torch_xlstm.py): the
# smoke model runs at 1e-2, where test_torch_xlstm.py holds it tightly
OVERRIDES = {"xlstm_350m": {"norm_eps": 1e-2}}


def _jparams(arch):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                               **OVERRIDES.get(arch, {}))
    return jcfg, split_params(JT.init_lm(jax.random.PRNGKey(0), jcfg))[0]


def _cases():
    cases = []
    for arch in ARCHS:
        jcfg, jparams = _jparams(arch)
        params = tree_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
        batch, prompt, decode = _inputs(jcfg)
        base = dict(arch=arch, params=params, mesh=(2, 2),
                    names=("data", "model"), overrides=OVERRIDES.get(arch, {}),
                    repeat=arch in REPEAT)
        cases.append(dict(base, name=f"{arch}-train", kind="train",
                          batch=_torch(batch), adam_eps=ADAM_EPS))
        cases.append(dict(base, name=f"{arch}-serve", kind="serve",
                          prompt=_torch(prompt),
                          decode=[_torch(d) for d in decode],
                          max_seq=MAX_SEQ))
        if arch == "smollm_360m":
            # the multi-pod axes with data 1 (2 x 1 x 2) as the 2-D mesh
            # (pod, model): a 3-D DeviceMesh stalls DTensor's sharding
            # propagation (it planned one matmul for over 90 s here)
            cases.append(dict(cases[-2], name=f"{arch}-train-multipod",
                              mesh=(2, 2), names=("pod", "model")))
    return cases


def _spawn(tmp, world, cases_path, tag):
    out = os.path.join(tmp, tag)
    os.makedirs(out)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return out, [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world),
         os.path.join(tmp, f"{tag}.store"), cases_path, out],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for r in range(world)]


def _wait(procs, deadline):
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode:
            errs.append(err.decode()[-3000:])
    assert not errs, errs[0]


def _jax_train(arch, batch):
    jcfg, jparams = _jparams(arch)
    tcfg = jstep.TrainStepConfig(
        opt=jadamw.AdamWConfig(weight_decay=0.01, eps=ADAM_EPS),
        remat="none", lr_peak=1e-3, warmup_steps=2, total_steps=100)
    opt = jadamw.adamw_init(jparams, tcfg.opt)
    step = jax.jit(jstep.build_train_step(jcfg, tcfg))
    return step(jparams, opt, jax.tree.map(jnp.asarray, batch),
                jnp.asarray(3, jnp.int32))


def _jax_serve(arch):
    jcfg, jparams = _jparams(arch)
    _, prompt, decode = _inputs(jcfg)
    cache = JT.init_cache(jcfg, B, MAX_SEQ)
    logits, cache = JT.lm_prefill(jparams, jax.tree.map(jnp.asarray, prompt),
                                  jcfg, cache)
    out = [logits]
    for d in decode:
        logits, cache = JT.lm_decode_step(
            jparams, jnp.asarray(d["tokens"]), jnp.asarray(d["positions"]),
            jcfg, cache)
        out.append(logits)
    return out, cache


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawns both worlds, computes the JAX package's results while they
    run, and returns {world: name -> its result} and the references."""
    tmp = str(tmp_path_factory.mktemp("sharded"))
    cases = _cases()
    torch.save(cases, os.path.join(tmp, "cases.pt"))
    torch.save([c for c in cases if c["arch"] in ONE_BY_ONE
                and "multipod" not in c["name"]],
               os.path.join(tmp, "cases1.pt"))
    deadline = time.time() + WORLD_TIMEOUT
    out4, procs4 = _spawn(tmp, 4, os.path.join(tmp, "cases.pt"), "w4")
    out1, procs1 = _spawn(tmp, 1, os.path.join(tmp, "cases1.pt"), "w1")
    try:
        refs = {}
        for arch in ARCHS:
            jcfg = _jparams(arch)[0]
            refs[f"{arch}-train"] = _jax_train(arch, _inputs(jcfg)[0])
            refs[f"{arch}-serve"] = _jax_serve(arch)
    finally:
        _wait(procs4 + procs1, deadline)

    def load(out, name):
        return torch.load(os.path.join(out, name + ".pt"), weights_only=False)

    return {"4": lambda n: load(out4, n), "1": lambda n: load(out1, n),
            "ref": refs}


def _close(t, j, **tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **tol)


def _close_to_scale(t, j, rel):
    j = np.asarray(j, np.float32)
    err = np.abs(t.float().numpy() - j).max()
    assert err <= rel * max(np.abs(j).max(), 1e-30), (err, j.shape)


@pytest.mark.parametrize("name", [f"{a}-train" for a in ARCHS]
                         + ["smollm_360m-train-multipod"])
def test_sharded_train_step_matches_reference(world, name):
    arch = name.split("-")[0]
    res = world["4"](name)
    got = res["sharded"]
    jp, jo, jm = world["ref"][f"{arch}-train"]
    m = got["metrics"]
    assert float(m["lr"]) == float(jm["lr"])
    _close(m["loss"], jm["loss"], **LOSS_TOL)
    _close(m["grad_norm"], jm["grad_norm"],
           rtol=GRAD_TO_SCALE.get(arch, LOSS_TOL["rtol"]))
    # the first moment after one step is 0.1 g: the gradients
    tg = flatten(got["opt"]["mu"])[0][0::2]
    jg = jax.tree.leaves(jo["mu"])[0::2]
    assert len(tg) == len(jg)
    for t, j in zip(tg, jg):
        if arch in GRAD_TO_SCALE:
            _close_to_scale(t, j, GRAD_TO_SCALE[arch])
        else:
            _close(t * 10, np.asarray(j) * 10, **GRAD_TOL)
    tl, jl = flatten(got["params"])[0], jax.tree.leaves(jp)
    assert len(tl) == len(jl)
    tol = dict(STEP_TOL, atol=STEP_ATOL.get(arch, STEP_TOL["atol"]))
    for t, j in zip(tl, jl):
        _close(t, j, **tol)
    assert int(got["opt"]["count"]) == int(jo["count"]) == 1
    assert res.get("repeat_equal", arch not in REPEAT)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_reference(world, arch):
    res = world["4"](f"{arch}-serve")
    got = res["sharded"]
    jlogits, jcache = world["ref"][f"{arch}-serve"]
    assert len(got["logits"]) == len(jlogits) == 3
    for t, j in zip(got["logits"], jlogits):
        _close(t, j, **SERVE_TOL)
    tl, jl = flatten(got["cache"])[0], jax.tree.leaves(jcache)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape
        if t.dtype == torch.int32:  # slot positions: exact
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        elif arch in STATE_TO_SCALE:
            _close_to_scale(t, j, STATE_TO_SCALE[arch])
        else:
            _close(t, j, **SERVE_TOL)
    assert res.get("repeat_equal", arch not in REPEAT)


@pytest.mark.parametrize("name", [f"{a}-{k}" for a in ONE_BY_ONE
                                  for k in ("train", "serve")])
def test_one_by_one_mesh_is_bit_equal_to_unsharded(world, name):
    res = world["1"](name)
    assert res["unsharded_equal"] and res["repeat_equal"]
