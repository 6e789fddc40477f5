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
    """The leaves' chunk entries; a chunk's parent image (``pim``) is
    given as its depth in the image's delta chain, since ids differ."""
    tree = reg._manifest(image_id)["trees"]["state"]
    chain = reg.delta_chain(image_id)
    out = []
    for leaf in tree["leaves"]:
        ent = {k: leaf[k] for k in ("dtype", "shape", "nbytes", "fps")}
        ent["chunks"] = [dict(ch, pim=chain.index(ch["pim"])) if "pim" in ch
                         else ch for ch in leaf["chunks"]]
        out.append(ent)
    return out


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


def test_flatten_and_unflatten_hold_no_leaf_after_they_return():
    """No reference cycle keeps a leaf alive past the call (a train
    step's gradients went through ``unflatten`` and lived until the
    garbage collector ran)."""
    import gc
    import weakref

    leaf = torch.zeros(4)
    ref = weakref.ref(leaf)
    enabled = gc.isenabled()
    gc.disable()
    try:
        treedef = flatten({"a": [leaf, None], "b": (leaf,)})[1]
        unflatten(treedef, [leaf, leaf])
        tree_map(lambda t: t, {"a": leaf})
        del leaf
        assert ref() is None
    finally:
        if enabled:
            gc.enable()


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


@pytest.mark.parametrize("backend", ["kernel", "host"])
def test_unported_codecs_raise_instead_of_storing_raw(registries, monkeypatch,
                                                      backend):
    """The parent-relative codecs, once refused here, are ported: a chain
    of ``xor_rle``/``int8``/``auto`` delta pushes (lossy rounds, then the
    exact flush) gives chunk entries and report byte fields identical to
    the JAX registry's, under the fused (``kernel``) and the two-pass
    (``host``) encoder, and pulls back the same bytes.  An unknown codec
    still raises."""
    monkeypatch.setenv("REPRO_CODEC_BACKEND", backend)
    jreg, treg = registries
    jr = jreg.push_image({"state": _as_jax(_state(2))})
    tr = treg.push_image({"state": _as_torch(_state(2))})
    for codec in ("xor_rle", "int8", "auto"):
        jp, tp = jr.image_id, tr.image_id
        for step, exact in ((1, False), (2, False), (3, True)):
            state = _state(2, dirty=True)
            state["extra"]["odd"][step * 100: step * 100 + 9] += step
            jd = jreg.push_delta({"state": _as_jax(state)}, jp,
                                 compression=codec, exact=exact)
            td = treg.push_delta({"state": _as_torch(state)}, tp,
                                 compression=codec, exact=exact)
            assert _report_fields(td) == _report_fields(jd), (codec, step)
            assert (_chunk_entries(treg, td.image_id)
                    == _chunk_entries(jreg, jd.image_id)), (codec, step)
            assert td.enc_raw_bytes > 0
            assert td.lossy == (codec == "int8" and not exact)
            jp, tp = jd.image_id, td.image_id
        enc = {ch.get("enc") for leaf in _chunk_entries(treg, tp)
               for ch in leaf["chunks"]}
        assert enc & {"xor_rle"}, enc
        jt, _ = jreg.pull_image(jp)
        tt, _ = treg.pull_image(tp)
        for a, b in zip(jax.tree.leaves(jt["state"]), flatten(tt["state"])[0]):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    with pytest.raises(ValueError, match="unknown compression"):
        treg.push_delta({"state": _as_torch(_state(2))}, tr.image_id,
                        compression="zstd")


def test_codec_backends_agree_on_chunk_entries(tmp_path, monkeypatch):
    """``REPRO_CODEC_BACKEND=kernel`` (one fused pass) and ``host`` (device
    fingerprints, host codecs) store the same chunks."""
    got = {}
    for backend in ("kernel", "host"):
        monkeypatch.setenv("REPRO_CODEC_BACKEND", backend)
        reg = TRegistry(str(tmp_path / backend), chunk_bytes=CHUNK)
        base = reg.push_image({"state": _as_torch(_state(4))})
        ids = []
        for codec in ("int8", "xor_rle"):
            d = reg.push_delta({"state": _as_torch(_state(4, dirty=True))},
                               base.image_id, compression=codec)
            ids.append(_chunk_entries(reg, d.image_id))
        got[backend] = ids
    assert got["kernel"] == got["host"]


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


@pytest.mark.parametrize("block", [False, True])
def test_checkpointer_image_equals_a_direct_push(tmp_path, block):
    """An async save (fingerprints taken on the leaves' device at the
    save, bytes copied to host memory) and a blocking one (the live
    tensors pushed with no copy) give the image a direct push of the same
    state gives: the same manifest, so the same image id."""
    state = _as_torch(_state(5))
    want = TRegistry(str(tmp_path / "direct"), chunk_bytes=CHUNK).push_image(
        {"state": state}, {"step": 3, "worker": "w"}, tag="w:latest")
    reg = TRegistry(str(tmp_path / "ck"), chunk_bytes=CHUNK)
    ck = Checkpointer(reg, "w", interval_steps=1)
    ck.maybe_save(2, {"state": _as_torch(_state(6))})  # a pending push
    got = ck.save(3, {"state": state}, block=block)
    if not block:
        state["extra"]["odd"].mul_(2.0)  # the worker goes on in place
        got = got.result()
    assert got.image_id == want.image_id
    assert (got.total_bytes, got.fp_bytes) == (want.total_bytes,
                                               want.fp_bytes)
    assert ck.latest() == (3, want.image_id)


def test_chunk_keys_on_the_pool_equal_serial_sha256():
    """The push hashes a leaf's chunks on a thread pool over a byte view
    of the leaf: the keys are each chunk's own sha256, the last chunk
    short, skipped chunks absent."""
    import hashlib

    from repro_torch.checkpoint import codecs, registry

    leaf = torch.from_numpy(np.random.default_rng(7).standard_normal(
        10_000).astype(np.float32)).to(torch.bfloat16)
    view = codecs.leaf_view(leaf)
    raw = codecs.leaf_raw(leaf)
    assert bytes(view) == raw and len(raw) == 20_000
    cb = 1024
    want = {c: hashlib.sha256(raw[c * cb: (c + 1) * cb]).hexdigest()
            for c in range(20) if c != 3}
    assert registry._chunk_keys(view, cb, sorted(want)) == want
    assert registry._chunk_keys(view, cb, [19]) == {19: want[19]}


class _ViewStore:
    """A chunk store in host memory whose ``get`` hands out read-only
    views of the blobs it holds, as the benchmark's does: a pulled leaf
    that aliased a view would alias the store."""

    def __init__(self):
        self._blobs = {}

    def has(self, key):
        return key in self._blobs

    def put(self, data, key=None):
        import hashlib

        key = key or hashlib.sha256(data).hexdigest()
        new = key not in self._blobs
        if new:
            self._blobs[key] = np.frombuffer(data, np.uint8).copy()
        return key, new

    def get(self, key):
        return memoryview(self._blobs[key]).toreadonly()


def _f32(n, seed=5):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _nudge(x):
    """A few elements of each 8 KiB chunk moved a little (the delta
    codecs then encode every chunk)."""
    y = x.copy()
    y.reshape(-1)[::1024] += 0.25
    return y


# name -> (the pushed tree, the delta's codec or None, its dirty tree)
_PULL_CASES = {
    "empty": ({"x": np.zeros((0, 3), np.float32)}, None, None),
    "under_one_chunk": ({"x": _f32(100)}, None, None),
    "one_chunk": ({"x": _f32(CHUNK // 4)}, None, None),
    "chunks_short_last": ({"x": _f32(5000).reshape(50, 100)}, None, None),
    "bfloat16": ({"x": torch.from_numpy(_f32(7001)).to(torch.bfloat16)},
                 None, None),
    "int8": ({"x": np.random.default_rng(6).integers(
        -128, 128, 20_001).astype(np.int8)}, None, None),
    "int64": ({"x": np.arange(2500, dtype=np.int64).reshape(5, 500)},
              None, None),
    "scalar": ({"s": np.int64(7), "f": np.array(2.5, np.float32)}, None,
               None),
    "delta_xor_rle": ({"x": _f32(6000), "y": _f32(3000, 8)}, "xor_rle",
                      {"x": _nudge(_f32(6000)), "y": _nudge(_f32(3000, 8))}),
    "delta_int8": ({"x": _f32(6000), "y": _f32(3000, 8)}, "int8",
                   {"x": _nudge(_f32(6000)), "y": _nudge(_f32(3000, 8))}),
}


def _expected_wire(reg, image_id):
    """The wire bytes of a cold pull, from the manifests alone: each
    distinct chunk of the image once, with the chunks its codecs decode
    against."""
    wire = {}

    def walk(im, name, li, ci):
        ch = reg._manifest(im)["trees"][name]["leaves"][li]["chunks"][ci]
        wire[ch["key"]] = ch["wire"]
        if ch.get("enc", "none") != "none":
            walk(ch["pim"], name, li, ci)

    for name, spec in reg._manifest(image_id)["trees"].items():
        for li, leaf in enumerate(spec["leaves"]):
            for ci in range(len(leaf["chunks"])):
                walk(image_id, name, li, ci)
    return sum(wire.values())


@pytest.mark.parametrize("store", ["disk", "memory"])
@pytest.mark.parametrize("case", sorted(_PULL_CASES))
def test_pull_places_each_leaf_in_memory_of_its_own(tmp_path, case, store):
    """A pull gives back the pushed bytes (a lossy delta's decode, chunk
    by chunk) as writable arrays that own their memory, share none with
    the store, and leave a second pull and the store unchanged when
    written to; ``pulled`` is the image's distinct chunks' wire bytes,
    its codecs' parents included."""
    from repro_torch.checkpoint.codecs import leaf_raw
    from repro_torch.checkpoint.registry import _leaf_meta

    tree, codec, dirty = _PULL_CASES[case]
    reg = TRegistry(str(tmp_path), chunk_bytes=CHUNK)
    if store == "memory":
        reg.store = _ViewStore()
    image_id = reg.push_image({"state": tree}).image_id
    if codec is not None:
        rep = reg.push_delta({"state": dirty}, image_id, compression=codec)
        image_id, tree = rep.image_id, dirty
        encs = {ch.get("enc") for leaf in _chunk_entries(reg, image_id)
                for ch in leaf["chunks"]}
        assert encs == {codec}, encs

    def raw(name, li):
        """The leaf's bytes as today's pull joined them, chunk by chunk."""
        leaf = reg._manifest(image_id)["trees"][name]["leaves"][li]
        return b"".join(bytes(reg._chunk_raw(image_id, name, li, ci))
                        for ci in range(len(leaf["chunks"])))

    first, pulled = reg.pull_image(image_id)
    second, _ = reg.pull_image(image_id)
    assert pulled == _expected_wire(reg, image_id)
    assert (pulled > 0) == (case != "empty")
    got, treedef = flatten(first["state"])
    want, want_def = flatten(tree)
    assert treedef == want_def
    views = [np.frombuffer(reg.store.get(k), np.uint8)
             for k in reg.image_chunks(image_id)]
    for li, (g, w) in enumerate(zip(got, want)):
        dtype, shape, nbytes = _leaf_meta(w)
        assert isinstance(g, np.ndarray)
        assert (g.dtype.name, g.shape, g.nbytes) == (dtype, shape, nbytes)
        assert g.flags.owndata and g.flags.writeable and g.flags.c_contiguous
        assert g.tobytes() == raw("state", li)
        if codec != "int8":
            assert g.tobytes() == leaf_raw(w)
        else:
            np.testing.assert_allclose(g, w, atol=0.02)
        assert not any(np.shares_memory(g, v) for v in views)
    for g in got:
        g.reshape(-1).view(np.uint8)[:] ^= 0xFF
    third, _ = reg.pull_image(image_id)
    for li, (b, c) in enumerate(zip(flatten(second["state"])[0],
                                    flatten(third["state"])[0])):
        assert b.tobytes() == c.tobytes() == raw("state", li)
