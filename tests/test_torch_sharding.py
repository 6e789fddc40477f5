"""The port's sharding layer against the JAX package's, exactly, with no
process group and no tensor of a full config allocated.

The reference's ``logical_to_spec`` reads only ``mesh.axis_names`` and
``mesh.devices.shape``, so it runs on a duck-typed mesh; its step helpers
build ``NamedSharding(mesh, spec)``, which is patched here to keep the
spec alone (the JAX package itself is not changed).  Shapes come from
``jax.eval_shape`` on the reference side and from meta tensors on the
port's.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.models.common import split_params as jsplit_params
from repro.models.config import SHAPES as JSHAPES
from repro.optim import adamw as jadamw
from repro.sharding import rules as JR
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun as tdryrun
from repro_torch.models import transformer as TT
from repro_torch.models.common import split_params
from repro_torch.models.config import SHAPES
from repro_torch.optim import adamw as tadamw
from repro_torch.sharding import rules as R
from repro_torch.train import step as tstep
from repro_torch.tree import flatten

ARCHS = ["paper_consumer"] + jconfigs.list_archs()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}


class _JMesh:
    """What the reference's resolver reads of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=np.int8)


class _JSharding:
    """Stands in for ``jax.sharding.NamedSharding``: keeps the spec (a
    pytree leaf)."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


@pytest.fixture(autouse=True)
def _specs_only(monkeypatch):
    monkeypatch.setattr(jstep, "NamedSharding", _JSharding)


def _meshes(name):
    shape, names = MESHES[name]
    return _JMesh(shape, names), R.AbstractMesh(names, shape)


def _jspecs(tree):
    return [s.spec for s in jax.tree.leaves(tree)]


def _tspecs(tree):
    return [tuple(s.spec) for s in flatten(tree)[0]]


def _jaxes(tree):
    return jax.tree.leaves(tree, is_leaf=jstep._axes_leaf)


def _taxes(tree):
    out = []
    R.map_axes(out.append, tree)
    return out


@functools.lru_cache(maxsize=None)
def _cfgs(arch):
    return jconfigs.get_config(arch), tconfigs.get_config(arch)


def _rules(jcfg, tcfg):
    jr, tr = jstep.arch_rules(jcfg), tstep.arch_rules(tcfg)
    jr.dropped.clear()
    tr.dropped.clear()
    return jr, tr


# ---------------------------------------------------------------------------
# the reference's rule cases (tests/test_optim_sharding.py)
# ---------------------------------------------------------------------------

def test_rules_divisibility_fallback():
    mesh = R.AbstractMesh(("model",), (1,))
    rules = R.AxisRules({"heads": "model", "mlp": "model"})
    # size-1 axis divides everything; 'model' consumed by the first dim
    spec = R.logical_to_spec(("heads", "mlp"), mesh, rules, dims=(8, 128))
    assert spec == R.PartitionSpec("model", None) == ("model", None)
    assert not rules.dropped


def test_rules_drop_nondivisible():
    mesh = R.AbstractMesh(("model",), (16,))
    rules = R.AxisRules({"heads": "model"})
    spec = R.logical_to_spec(("heads",), mesh, rules, dims=(15,))
    assert spec == (None,)  # 15 % 16 != 0 -> dropped
    assert rules.dropped == [("heads", 15, ("model",))]
    assert R.logical_to_spec(("heads",), mesh, rules, dims=(32,)) == \
        ("model",)


def test_rules_absent_mesh_axes_filtered():
    mesh = R.AbstractMesh(("data", "model"), (1, 1))
    # 'batch' maps to ('pod','data'); 'pod' absent on single-pod mesh
    spec = R.logical_to_spec(("batch", None), mesh, R.DEFAULT_RULES,
                             dims=(8, 8))
    assert spec == ("data", None)
    multi = R.AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    assert R.logical_to_spec(("batch", None), multi, R.DEFAULT_RULES,
                             dims=(64, 8)) == (("pod", "data"), None)


def test_default_rules_are_the_reference_rules():
    assert dict(R.DEFAULT_RULES.rules) == dict(JR.DEFAULT_RULES.rules)
    over = R.DEFAULT_RULES.overriding(seq="model", act_heads=None)
    assert over.rules["seq"] == "model" and over.dropped == []
    assert R.DEFAULT_RULES.rules["seq"] is None


@pytest.mark.parametrize("axes,dims", [
    (("batch", "seq", "act_heads", None), (32, 64, 16, 8)),
    (("embed", "mlp"), (960, 2560)),
    (("heads", "heads", "mlp"), (32, 32, 15)),
    (("layers", "batch", "kv_seq", "act_kv_heads", None), (4, 6, 32, 5, 64)),
    ((None, "batch", None), (3, 2, 7)),
])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_logical_to_spec_matches_reference(axes, dims, mesh):
    jm, tm = _meshes(mesh)
    jr, tr = JR.DEFAULT_RULES.overriding(), R.DEFAULT_RULES.overriding()
    for d in (dims, None):
        assert tuple(JR.logical_to_spec(axes, jm, jr, d)) == \
            tuple(R.logical_to_spec(axes, tm, tr, d))
    assert [tuple(x) for x in jr.dropped] == tr.dropped


def test_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    multi = R.AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    assert R.placements((("pod", "data"), None, "model"), multi,
                        (64, 3, 32)) == (Shard(0), Shard(0), Shard(2))
    assert R.placements((None, "data"), multi) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(AssertionError, match="mesh's order"):
        R.placements((("data", "pod"),), multi)
    with pytest.raises(AssertionError):
        R.placements(("model",), multi, (15,))


def test_constraint_is_a_noop_on_plain_tensors():
    x = torch.arange(6.0).reshape(2, 3)
    assert R.with_sharding_constraint_logical(x, ("batch", None)) is x


# ---------------------------------------------------------------------------
# every full config: params, optimizer state, caches and batches
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jparam_axes(arch):
    leaves = jax.eval_shape(lambda k: JT.init_lm(k, _cfgs(arch)[0]),
                            jax.random.PRNGKey(0))
    return jsplit_params(leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_and_shapes_match_reference(arch):
    jvals, jaxes = _jparam_axes(arch)
    tvals, taxes = tstep.param_shapes_and_axes(_cfgs(arch)[1])
    assert _taxes(taxes) == _jaxes(jaxes)
    tl = flatten(tvals)[0]
    assert all(t.device.type == "meta" for t in tl)
    assert [tuple(t.shape) for t in tl] == \
        [x.shape for x in jax.tree.leaves(jvals)]
    assert [str(t.dtype).split(".")[1] for t in tl] == \
        [str(x.dtype) for x in jax.tree.leaves(jvals)]
    # the spec tree is the tree init_lm draws
    _, b16 = tstep.param_shapes_and_axes(_cfgs(arch)[1], "bfloat16")
    assert _taxes(b16) == _taxes(taxes)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_shardings_match_reference(arch, mesh, param_dtype):
    jcfg, tcfg = _cfgs(arch)
    jm, tm = _meshes(mesh)
    jr, tr = _rules(jcfg, tcfg)
    topt = tdryrun.opt_config_for(tcfg)  # the reference's choice
    jopt = jadamw.AdamWConfig(**dataclasses.asdict(topt))
    jp, jps, jo, jos = jstep.train_state_shardings(
        jcfg, jm, jopt, jr, param_dtype=param_dtype)
    tp, tps, to, tos = tstep.train_state_shardings(
        tcfg, tm, topt, tr, param_dtype=param_dtype)
    assert _tspecs(tps) == _jspecs(jps)
    assert _tspecs(tos) == _jspecs(jos)
    assert tr.dropped == [tuple(d) for d in jr.dropped]
    tol = flatten(to)[0]
    assert [tuple(t.shape) for t in tol] == \
        [x.shape for x in jax.tree.leaves(jo)]
    assert all(t.device.type == "meta" for t in tol)
    if arch == "llama4_maverick_400b_a17b":  # factored: v is {row, col}
        assert jopt.factored and "'row'" in str(flatten(to["mu"])[1])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_shardings_match_reference(arch, mesh):
    jcfg, tcfg = _cfgs(arch)
    jm, tm = _meshes(mesh)
    for name, jshape in JSHAPES.items():
        tshape = SHAPES[name]
        assert dataclasses.asdict(tshape) == dataclasses.asdict(jshape)
        jr, tr = _rules(jcfg, tcfg)
        jb = jstep.batch_shardings(jcfg, jshape, jm, jr)
        tb = tstep.batch_shardings(tcfg, tshape, tm, tr)
        assert list(tb) == list(jb)
        assert [tuple(s.spec) for s in tb.values()] == \
            [s.spec for s in jb.values()]
        jin, tin = jstep.input_specs(jcfg, jshape), tstep.input_specs(
            tcfg, tshape)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
                for k, v in tin.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in jin.items()}
        assert tstep.batch_logical_axes(tcfg, tshape) == \
            jstep.batch_logical_axes(jcfg, jshape)
        if jshape.kind != "decode":
            assert tr.dropped == [tuple(d) for d in jr.dropped]
            continue
        jc, jcs = jstep.cache_shardings(jcfg, jshape, jm, jr)
        tc, tcs = tstep.cache_shardings(tcfg, tshape, tm, tr)
        assert _tspecs(tcs) == _jspecs(jcs)
        tcl = flatten(tc)[0]
        assert [tuple(t.shape) for t in tcl] == \
            [x.shape for x in jax.tree.leaves(jc)]
        assert all(t.device.type == "meta" for t in tcl)
        assert tr.dropped == [tuple(d) for d in jr.dropped]


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_have_init_cache_structure(arch):
    jcfg, tcfg = _cfgs(arch)
    axes = TT.cache_logical_axes(tcfg)
    assert _taxes(axes) == _jaxes(JT.cache_logical_axes(jcfg))
    cache = TT.init_cache(tcfg, 2, 16, device="meta")
    flat_axes = []
    ranks = R.map_axes(lambda a, t: flat_axes.append(a) or len(a) == t.dim(),
                       axes, cache)
    assert all(flatten(ranks)[0])
    assert len(flat_axes) == len(flatten(cache)[0])


def test_opt_state_axes_match_reference():
    jcfg, tcfg = _cfgs("smollm_360m")
    _, jaxes = _jparam_axes("smollm_360m")
    _, taxes = tstep.param_shapes_and_axes(tcfg)
    j = jadamw.opt_state_logical_axes(jaxes, jadamw.AdamWConfig())
    t = tadamw.opt_state_logical_axes(taxes, tadamw.AdamWConfig())
    assert _taxes(t) == _jaxes(j)
    with pytest.raises(NotImplementedError):
        tadamw.opt_state_logical_axes(taxes,
                                      tadamw.AdamWConfig(factored=True))
    assert tadamw.AdamWConfig().min_factored_dim == \
        jadamw.AdamWConfig().min_factored_dim == 128


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_of_each_arch_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    assert jstep.arch_rules(jcfg).rules == tstep.arch_rules(tcfg).rules
    assert jstep.decode_rules(jcfg).rules == tstep.decode_rules(tcfg).rules


@pytest.mark.parametrize("arch", ["paper_consumer", "recurrentgemma_2b",
                                  "xlstm_350m", "granite_moe_1b_a400m",
                                  "whisper_large_v3", "qwen2_vl_72b"])
def test_lm_specs_are_the_tree_init_lm_draws(arch):
    """The spec tree's meta tensors have the keys, shapes and dtypes of
    the tree ``init_lm`` draws (whose bits the axes do not touch)."""
    cfg = tconfigs.get_smoke(arch)
    metas, axes = split_params(TT.lm_specs(cfg))
    drawn = TT.init_lm(cfg, device="cpu")
    assert flatten(metas)[1] == flatten(drawn)[1]
    assert [(t.shape, t.dtype) for t in flatten(metas)[0]] == \
        [(t.shape, t.dtype) for t in flatten(drawn)[0]]
    assert len(_taxes(axes)) == len(flatten(drawn)[0])
