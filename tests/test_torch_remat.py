"""The port's ``remat`` policies against the reference's, on the CPU.

``remat="dots"`` is the reference's
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: each layer
group is checkpointed, the outputs of the products with no batch dims are
saved, everything else is recomputed in the backward pass.  ``"full"``
saves nothing.  What is held here:

* every product inside a group, by file and line, dispatches as the aten
  op of its class (``PRODUCTS``): ``mm`` for a product with no batch dims
  (``x @ W``), ``bmm`` for a batched one;
* per group, the shapes and dtypes of the outputs that the port's
  ``save_dots`` marks to save are, as a multiset, the reference's saved
  dot outputs (``jax.ad_checkpoint.print_saved_residuals`` under ``dots``,
  less those under ``full``); under ``full`` the port marks nothing;
* in the backward pass, ``dots`` runs no forward ``mm`` again and
  ``full`` runs each once more; both run every batched product again,
  except a group's last product, which only the group's output reads:
  the recompute stops before it, as the reference's DCE drops it;
* the gradients of every policy are the same bits (``remat`` changes
  what is kept, not what is computed).
"""
import collections
import contextlib
import dataclasses
import io
import re
import traceback

import jax
import jax.ad_checkpoint
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.models.common import split_params
from repro_torch import configs as tconfigs
from repro_torch.convert import tree_from_jax
from repro_torch.models import transformer as TT
from repro_torch.tree import flatten, tree_map, unflatten

ARCHS = ["smollm_360m", "recurrentgemma_2b", "granite_moe_1b_a400m"]
B, S = 2, 16

MM = torch.ops.aten.mm.default
BMM = torch.ops.aten.bmm.default
# every product inside a layer group of ARCHS' blocks, by file:line under
# src/repro_torch: the aten op it dispatches as, which is its class.  mm:
# no batch dims (``x @ W`` against a 2-D weight: a view, then mm), saved
# by ``dots``; bmm: batched, recomputed
PRODUCTS = {
    "models/attention.py:68": MM,    # x @ wq
    "models/attention.py:69": MM,    # kv_x @ wk, kv_x @ wv
    "models/attention.py:102": MM,   # attention output @ wo
    "models/mlp.py:29": MM,          # x @ w_up
    "models/mlp.py:31": MM,          # x @ w_gate
    "models/mlp.py:35": MM,          # h @ w_down
    "models/moe.py:80": MM,          # router: xf @ router
    "models/moe.py:114": BMM,        # expert einsum ecd,edf (batch e)
    "models/moe.py:115": BMM,        # expert einsum ecd,edf (batch e)
    "models/moe.py:116": BMM,        # expert einsum ecf,efd (batch e)
    "models/moe.py:198": BMM,        # combine bskd,bsk->bsd (batch b, s)
    "models/rglru.py:72": BMM,       # gate einsum bshi,hij (batch h)
    "models/rglru.py:73": BMM,       # gate einsum bshi,hij (batch h)
    "models/rglru.py:83": MM,        # x @ w_gate_branch
    "models/rglru.py:85": MM,        # x @ w_x
    "models/rglru.py:101": MM,       # (hs * gate_branch) @ w_out
    # the flash kernel's plain version (q k^T and p v, batch b and heads);
    # on the card the kernel itself, which is no dispatcher op
    "kernels/ref.py:51": BMM,
    "kernels/ref.py:61": BMM,
}
_PRODUCT_OPS = (MM, BMM, torch.ops.aten.addmm.default,
                torch.ops.aten.baddbmm.default)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jparams, _ = split_params(JT.init_lm(jax.random.PRNGKey(0), jcfg))
    tparams = tree_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    return x, np.ascontiguousarray(pos)


def _where(stack) -> str:
    """The innermost frame under src/repro_torch, as models/x.py:N."""
    for f in reversed(stack):
        if "repro_torch" in f.filename:
            return (f.filename.split("repro_torch/")[-1]
                    + f":{f.lineno}")
    return "?"


class _Products(TorchDispatchMode):
    """Counts products by op and by pass (forward or backward, where the
    autograd engine runs a node), and records where each forward one was
    called."""

    def __init__(self, where=False):
        super().__init__()
        self.count = collections.Counter()
        self.sites = collections.Counter()
        self.order = []
        self.where = where

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _PRODUCT_OPS:
            backward = torch._C._current_autograd_node() is not None
            self.count[(func, "backward" if backward else "forward")] += 1
            if self.where and not backward:
                self.sites[(_where(traceback.extract_stack()), func)] += 1
                self.order.append(func)
        return out


def _group_run(cfg, groups, x, pos, remat, mode=None):
    """One forward and backward of ``_run_groups`` (a sum of the output
    and the aux loss) -> gradients of the groups' leaves and of x."""
    flat, treedef = flatten(groups)
    inputs = [t.detach().clone().requires_grad_() for t in flat]
    xin = torch.from_numpy(x).to(cfg.compute_dtype).requires_grad_()
    with mode or contextlib.nullcontext():
        y, aux = TT._run_groups(unflatten(treedef, inputs), xin,
                                torch.from_numpy(pos), cfg, remat=remat)
        grads = torch.autograd.grad(y.sum() + aux, inputs + [xin])
    return grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_product_in_a_group_dispatches_as_its_class(arch, dtype):
    _, _, tcfg, tparams = _models(arch)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    x, pos = _inputs(tcfg)
    mode = _Products(where=True)
    _group_run(tcfg, tparams["groups"], x, pos, "none", mode)
    sites = {site for site, _ in mode.sites}
    assert sites <= set(PRODUCTS), sites - set(PRODUCTS)
    for (site, op), n in mode.sites.items():
        assert op == PRODUCTS[site], (site, op)


def _reference_saved_dots(jcfg, jparams, x, pos):
    """The reference's saved residuals of one group under ``dots`` less
    those under ``full`` (the policy's saved dot outputs), as a multiset
    of ((rows, cols), dtype)."""
    g1 = jax.tree.map(lambda a: a[:1], jparams["groups"])
    x, pos = jnp.asarray(x), jnp.asarray(pos)

    def residuals(remat):
        def f(g, x):
            y, aux = JT._run_groups(g, x, pos, jcfg, remat=remat,
                                    unroll=True)
            return jnp.sum(y) + aux

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            jax.ad_checkpoint.print_saved_residuals(f, g1, x)
        out = collections.Counter()
        for line in buf.getvalue().splitlines():
            m = re.match(r"(\w+)\[([\d,]*)\] ", line)
            shape = tuple(int(d) for d in m.group(2).split(",") if d)
            out[(_rows_cols(shape), m.group(1))] += 1
        return out

    dots, full = residuals("dots"), residuals("full")
    assert not full - dots  # the policy only adds saved values
    return dots - full


def _rows_cols(shape):
    """A product's output as (rows, cols): the port's mm flattens the
    leading dims the reference's dot keeps."""
    return (int(np.prod(shape[:-1])), shape[-1]) if shape else ()


_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _port_saved(cfg, groups, x, pos, remat, monkeypatch):
    """In one group's forward and backward, the outputs the port's policy
    marks to save (forward), and the saved values the backward's recompute
    reads back, each as a multiset of ((rows, cols), dtype)."""
    marked, read = collections.Counter(), collections.Counter()
    policy = TT.save_dots if remat == "dots" else TT.save_nothing

    def key(t):
        return (_rows_cols(tuple(t.shape)), _DTYPES[t.dtype])

    def recording(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if decision == TT.CheckpointPolicy.MUST_SAVE:
            meta = tree_map(lambda t: t.to("meta"), list(args))
            marked[key(op(*meta, **kwargs))] += 1
        return decision

    get_val = torch.utils.checkpoint._VersionWrapper.get_val

    def reading(self, *args):
        out = get_val(self, *args)
        read[key(out)] += 1
        return out

    monkeypatch.setattr(TT, "save_dots" if remat == "dots"
                        else "save_nothing", recording)
    monkeypatch.setattr(torch.utils.checkpoint._VersionWrapper, "get_val",
                        reading)
    g1 = tree_map(lambda a: a[:1], groups)
    _group_run(cfg, g1, x, pos, remat)
    return marked, read


def _forward_products(cfg, groups, x, pos):
    """-> (the ops of one group's forward products in order, the count of
    groups)."""
    mode = _Products(where=True)
    _group_run(cfg, tree_map(lambda a: a[:1], groups), x, pos, "none", mode)
    return mode.order, flatten(groups)[0][0].shape[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_saves_what_the_reference_saves(arch, monkeypatch):
    """The reference saves the dot outputs its backward needs (it drops the
    rest), so where a group ends in a product with no batch dims (w_down,
    w_out), the port's policy marks that one more: only the group's
    output reads it, and the recompute stops before it.  What the
    recompute reads back is the reference's list."""
    jcfg, jparams, tcfg, tparams = _models(arch)
    x, pos = _inputs(tcfg)
    want = _reference_saved_dots(jcfg, jparams, x, pos)
    marked, read = _port_saved(tcfg, tparams["groups"], x, pos, "dots",
                               monkeypatch)
    assert sum(want.values()) > 0
    assert read == want
    order, _ = _forward_products(tcfg, tparams["groups"], x, pos)
    last = (collections.Counter({((B * S, tcfg.d_model), "f32"): 1})
            if order[-1] == MM else collections.Counter())
    assert marked == want + last
    assert _port_saved(tcfg, tparams["groups"], x, pos, "full",
                       monkeypatch) == (collections.Counter(),) * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_backward_reruns_what_each_policy_did_not_save(arch):
    """Forward and backward products over all the smoke model's groups:
    ``dots`` runs the backward's own mm and no forward one again, ``full``
    each forward mm once more; both run every forward bmm again.  Neither
    reruns a group's last product: only the group's output reads it, and
    the recompute stops before it (the reference's DCE drops it too).
    The gradients are the same bits under every policy."""
    _, _, tcfg, tparams = _models(arch)
    x, pos = _inputs(tcfg)
    order, G = _forward_products(tcfg, tparams["groups"], x, pos)
    counts, grads = {}, {}
    for remat in TT.REMAT:
        mode = _Products()
        grads[remat] = _group_run(tcfg, tparams["groups"], x, pos, remat,
                                  mode)
        counts[remat] = mode.count
    none, dots, full = (counts[r] for r in ("none", "dots", "full"))
    fwd = {op: none[(op, "forward")] for op in (MM, BMM)}
    assert fwd[MM] == G * order.count(MM) and fwd[BMM] == G * order.count(BMM)
    assert fwd[MM] > 0 and fwd[BMM] > 0
    unread = {op: G * (order[-1] == op) for op in (MM, BMM)}
    for c in (dots, full):  # the forward pass is the same
        assert all(c[(op, "forward")] == fwd[op] for op in (MM, BMM))
    assert dots[(MM, "backward")] == none[(MM, "backward")]
    assert full[(MM, "backward")] == (none[(MM, "backward")] + fwd[MM]
                                      - unread[MM])
    for c in (dots, full):
        assert c[(BMM, "backward")] == (none[(BMM, "backward")] + fwd[BMM]
                                        - unread[BMM])
    for remat in ("dots", "full"):
        assert all(torch.equal(a, b)
                   for a, b in zip(grads["none"], grads[remat]))
