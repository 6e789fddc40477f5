"""The port's checkpoint registry against the JAX package's, on the CPU.

The same leaves go to both registries.  Chunk keys, fingerprints, wire
and raw sizes and every byte field of the push reports must be identical;
only image ids differ (the manifests store different treedef encodings).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Registry as JRegistry
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import Registry as TRegistry
from repro_torch.convert import to_tensor
from repro_torch.tree import flatten, tree_map, unflatten

CHUNK = 8 * 1024


def _state(seed, dirty=False):
    """A state tree as numpy: a KV-like cache spanning several chunks,
    odd sizes, bf16 (as float32 to be cast), bool and numpy scalars."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((2, 1, 64, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 1, 64, 2, 16)).astype(np.float32)
    if dirty:
        k[1, 0, 5] += 1.0  # one slot of one layer: one dirty chunk
    return {
        "cache": {"b0": {"k": k, "v": v,
                         "pos": np.arange(2 * 64, dtype=np.int32).reshape(2, 1, 64)}},
        "extra": {"odd": rng.standard_normal(1001).astype(np.float32),
                  "half": rng.standard_normal((3, 5)).astype(np.float32),
                  "mask": rng.random(77) > 0.5},
        "scalars": {"pos": np.int64(7), "last_msg_id": np.int64(-1)},
    }


def _as_jax(tree):
    out = {}
    for name, sub in tree.items():
        if isinstance(sub, dict):
            out[name] = _as_jax(sub)
        elif name == "half":
            out[name] = jnp.asarray(sub, jnp.bfloat16)
        elif isinstance(sub, np.ndarray):
            out[name] = jnp.asarray(sub)
        else:
            out[name] = sub  # numpy scalars stay host leaves in both
    return out


def _as_torch(tree):
    out = {}
    for name, sub in tree.items():
        if isinstance(sub, dict):
            out[name] = _as_torch(sub)
        elif name == "half":
            out[name] = torch.from_numpy(sub).to(torch.bfloat16)
        elif isinstance(sub, np.ndarray):
            out[name] = torch.from_numpy(sub.copy())
        else:
            out[name] = sub
    return out


def _report_fields(report):
    d = dataclasses.asdict(report)
    d.pop("image_id")
    d.pop("parent_id")
    return d


def _chunk_entries(reg, image_id):
    tree = reg._manifest(image_id)["trees"]["state"]
    return [{k: leaf[k] for k in ("dtype", "shape", "nbytes", "chunks", "fps")}
            for leaf in tree["leaves"]]


def test_flatten_orders_leaves_as_jax():
    """Registry leaf indices: dict keys sorted (not insertion order), lists
    and tuples in order, None an empty subtree — as ``jax.tree``."""
    tree = {"z": [1, (2, 3)], "a": {"y": 4, "b": None, "c": np.int64(5)},
            "m": ()}
    leaves, treedef = flatten(tree)
    assert leaves == jax.tree.leaves(tree)
    assert unflatten(treedef, leaves) == tree
    with pytest.raises(ValueError):
        unflatten(treedef, leaves + [6])


@pytest.fixture
def registries(tmp_path):
    return (JRegistry(str(tmp_path / "jax"), chunk_bytes=CHUNK),
            TRegistry(str(tmp_path / "torch"), chunk_bytes=CHUNK))


def test_push_and_delta_identical_to_jax(registries):
    jreg, treg = registries
    base, dirty = _state(0), _state(0, dirty=True)
    jr = jreg.push_image({"state": _as_jax(base)})
    tr = treg.push_image({"state": _as_torch(base)})
    assert _report_fields(tr) == _report_fields(jr)
    assert _chunk_entries(treg, tr.image_id) == _chunk_entries(jreg, jr.image_id)
    jd = jreg.push_delta({"state": _as_jax(dirty)}, jr.image_id)
    td = treg.push_delta({"state": _as_torch(dirty)}, tr.image_id)
    assert _report_fields(td) == _report_fields(jd)
    assert 0 < td.delta_bytes < td.total_bytes and td.fp_clean_chunks > 0
    assert _chunk_entries(treg, td.image_id) == _chunk_entries(jreg, jd.image_id)
    assert treg.delta_chain(td.image_id) == [td.image_id, tr.image_id]


def test_pull_round_trip_is_exact(registries):
    _, treg = registries
    state = _as_torch(_state(1))
    report = treg.push_image({"state": state}, meta={"step": 3}, tag="t")
    trees, pulled = treg.pull_image(report.image_id)
    assert pulled == report.written_bytes
    assert treg.image_meta(report.image_id) == {"step": 3}
    assert treg.resolve("t") == report.image_id
    got, got_def = flatten(trees["state"])
    want, want_def = flatten(state)
    assert got_def == want_def
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        if isinstance(w, torch.Tensor):
            assert torch.equal(to_tensor(g, "cpu"), w)
        else:
            assert g == w and g.dtype == np.asarray(w).dtype


def test_unported_codecs_raise_instead_of_storing_raw(registries):
    _, treg = registries
    r = treg.push_image({"state": _as_torch(_state(2))})
    for codec in ("xor_rle", "int8", "auto"):
        with pytest.raises(NotImplementedError, match="not ported"):
            treg.push_delta({"state": _as_torch(_state(2, dirty=True))},
                            r.image_id, compression=codec)
    with pytest.raises(ValueError, match="unknown compression"):
        treg.push_delta({"state": _as_torch(_state(2))}, r.image_id,
                        compression="zstd")


def test_checkpointer_snapshots_before_the_caller_mutates(tmp_path):
    reg = TRegistry(str(tmp_path), chunk_bytes=CHUNK)
    ck = Checkpointer(reg, "w", interval_steps=2)
    state = _as_torch(_state(3))
    before = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                      else x, state)
    fut = ck.maybe_save(4, {"state": state})
    state["cache"]["b0"]["k"].add_(1.0)  # the worker goes on in place
    fut.result()
    step, trees = ck.restore_latest()
    assert step == 4
    k = trees["state"]["cache"]["b0"]["k"]
    assert torch.equal(torch.from_numpy(k), before["cache"]["b0"]["k"])
    assert ck.maybe_save(5, {"state": state}) is None
