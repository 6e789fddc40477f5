"""The MoE global route and the ``dots`` remat policy run sharded as
DTensors, on 4 gloo ranks, against the JAX package.

The worlds and what is compared are those of
``test_torch_sharded_step.py`` (whose helpers and tolerances this file
reuses): one world of 4 ranks runs every case on a 2 x 2 ``(data,
model)`` mesh, one of 1 rank on a 1 x 1 mesh and unsharded.  The cases:

* granite_moe_1b_a400m's and llama4_maverick_400b_a17b's smoke configs
  with ``moe_routing="global"``: a train step and a prefill + 2 decode
  steps against the JAX package's global route on the same converted
  params; on 1 x 1, bit-equal to the unsharded global route;
* smollm_360m's train step under ``remat="dots"`` (the selective
  checkpoint on DTensor ops): on 4 ranks against the JAX package, on
  1 x 1 bit-equal to the same step under ``"none"``.
"""
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_sharded_step as base
from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.models.common import split_params
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.convert import tree_from_jax
from repro_torch.tree import flatten

GLOBAL = {"moe_routing": "global"}
MOE = ["granite_moe_1b_a400m", "llama4_maverick_400b_a17b"]
WORLD_TIMEOUT = 300


def _jparams(arch, overrides):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **overrides)
    return jcfg, split_params(JT.init_lm(jax.random.PRNGKey(0), jcfg))[0]


def _cases():
    cases = []
    for arch, overrides, tag in ([(a, GLOBAL, "global") for a in MOE]
                                 + [("smollm_360m", {}, "none")]):
        jcfg, jparams = _jparams(arch, overrides)
        params = tree_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
        batch, prompt, decode = base._inputs(jcfg)
        case = dict(arch=arch, params=params, mesh=(2, 2),
                    names=("data", "model"), overrides=overrides,
                    repeat=False, kind="train", batch=base._torch(batch),
                    adam_eps=base.ADAM_EPS, name=f"{arch}-{tag}-train")
        if tag == "none":  # smollm: the same step under each policy
            cases.append(dict(case, world=(1,)))
            cases.append(dict(case, remat="dots", world=(1, 4),
                              name=f"{arch}-dots-train"))
            continue
        cases.append(dict(case, world=(1, 4)))
        cases.append(dict(case, kind="serve", world=(1, 4),
                          name=f"{arch}-{tag}-serve", prompt=base._torch(prompt),
                          decode=[base._torch(d) for d in decode],
                          max_seq=base.MAX_SEQ))
    return cases


def _jax_train(jcfg, jparams, batch):
    tcfg = jstep.TrainStepConfig(
        opt=jadamw.AdamWConfig(weight_decay=0.01, eps=base.ADAM_EPS),
        remat="none", lr_peak=1e-3, warmup_steps=2, total_steps=100)
    opt = jadamw.adamw_init(jparams, tcfg.opt)
    step = jax.jit(jstep.build_train_step(jcfg, tcfg))
    return step(jparams, opt, jax.tree.map(jnp.asarray, batch),
                jnp.asarray(3, jnp.int32))


def _jax_serve(jcfg, jparams):
    _, prompt, decode = base._inputs(jcfg)
    cache = JT.init_cache(jcfg, base.B, base.MAX_SEQ)
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
    tmp = str(tmp_path_factory.mktemp("sharded_global_remat"))
    cases = _cases()
    for n in (1, 4):
        torch.save([c for c in cases if n in c["world"]],
                   os.path.join(tmp, f"cases{n}.pt"))
    deadline = time.time() + WORLD_TIMEOUT
    out4, procs4 = base._spawn(tmp, 4, os.path.join(tmp, "cases4.pt"), "w4")
    out1, procs1 = base._spawn(tmp, 1, os.path.join(tmp, "cases1.pt"), "w1")
    try:
        refs = {}
        for arch, overrides in [(a, GLOBAL) for a in MOE] + [
                ("smollm_360m", {})]:
            jcfg, jparams = _jparams(arch, overrides)
            refs[f"{arch}-train"] = _jax_train(jcfg, jparams,
                                               base._inputs(jcfg)[0])
            if overrides:
                refs[f"{arch}-serve"] = _jax_serve(jcfg, jparams)
    finally:
        base._wait(procs4 + procs1, deadline)

    def load(out, name):
        return torch.load(os.path.join(out, name + ".pt"), weights_only=False)

    return {"4": lambda n: load(out4, n), "1": lambda n: load(out1, n),
            "ref": refs}


def _check_train(got, ref):
    """``test_torch_sharded_step.py``'s train comparison: loss, grad norm,
    gradients (the first moment after one step is 0.1 g), params."""
    jp, jo, jm = ref
    m = got["metrics"]
    assert float(m["lr"]) == float(jm["lr"])
    base._close(m["loss"], jm["loss"], **base.LOSS_TOL)
    base._close(m["grad_norm"], jm["grad_norm"], **base.LOSS_TOL)
    tg = flatten(got["opt"]["mu"])[0][0::2]
    jg = jax.tree.leaves(jo["mu"])[0::2]
    assert len(tg) == len(jg)
    for t, j in zip(tg, jg):
        base._close(t * 10, np.asarray(j) * 10, **base.GRAD_TOL)
    tl, jl = flatten(got["params"])[0], jax.tree.leaves(jp)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        base._close(t, j, **base.STEP_TOL)
    assert int(got["opt"]["count"]) == int(jo["count"]) == 1


@pytest.mark.parametrize("arch", MOE)
def test_sharded_global_route_train_step_matches_reference(world, arch):
    _check_train(world["4"](f"{arch}-global-train")["sharded"],
                 world["ref"][f"{arch}-train"])


@pytest.mark.parametrize("arch", MOE)
def test_sharded_global_route_prefill_and_decode_match_reference(world, arch):
    got = world["4"](f"{arch}-global-serve")["sharded"]
    jlogits, jcache = world["ref"][f"{arch}-serve"]
    assert len(got["logits"]) == len(jlogits) == 3
    for t, j in zip(got["logits"], jlogits):
        base._close(t, j, **base.SERVE_TOL)
    tl, jl = flatten(got["cache"])[0], jax.tree.leaves(jcache)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape
        if t.dtype == torch.int32:  # slot positions: exact
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            base._close(t, j, **base.SERVE_TOL)


@pytest.mark.parametrize("name", [f"{a}-global-{k}" for a in MOE
                                  for k in ("train", "serve")])
def test_global_route_one_by_one_mesh_is_bit_equal_to_unsharded(world, name):
    assert world["1"](name)["unsharded_equal"]


def test_sharded_dots_train_step_matches_reference(world):
    _check_train(world["4"]("smollm_360m-dots-train")["sharded"],
                 world["ref"]["smollm_360m-train"])


def test_dots_on_one_by_one_mesh_is_bit_equal_to_none(world):
    dots = world["1"]("smollm_360m-dots-train")
    none = world["1"]("smollm_360m-none-train")
    assert dots["unsharded_equal"] and none["unsharded_equal"]
    a, b = flatten(dots["sharded"])[0], flatten(none["sharded"])[0]
    assert len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
