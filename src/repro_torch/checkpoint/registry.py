"""Forensic-checkpointing analogue: content-addressed checkpoint registry.

The paper checkpoints containers with CRIU, builds OCI images with Buildah
and pushes them to an artifact registry, decoupling source and target nodes.
Our unit of state is a well-typed pytree, so the "image" is:

  * chunks: the leaf raw bytes, split into fixed-size segments; each
    stored segment sits under the sha256 of its *stored* (possibly
    codec-encoded) bytes (content addressing = layer dedup: pushing a
    serving replica's image re-uploads *only* the KV-cache chunks — the
    weight chunks are already in the registry, exactly like a container
    image's cached base layers, cf. Ma et al. [12]).
  * manifest: JSON treedefs + per-leaf dtype/shape + per-chunk
    ``{key, enc, wire, raw}`` entries, itself stored by hash; the image id
    is the manifest hash (immutable, verifiable — the "forensic"
    property).
  * delta manifests: ``push_delta`` references a *parent* image id; the
    wire cost of the push is only the chunks absent from the parent
    (content addressing gives chunk-level diffing for free), which is
    what makes iterative pre-copy rounds cheap — each round uploads the
    dirty set since the previous checkpoint, not the whole state.

Two data-path optimizations ride on the delta manifests:

  * device-side fingerprints — every leaf is reduced to one 128-bit
    fingerprint per chunk *on device* (``repro_torch.kernels.ops
    .chunk_fingerprint``; the CUDA kernel for a CUDA tensor) and the
    fingerprints are recorded in the manifest.  A delta push compares
    them against the parent's: chunks with equal fingerprints reuse the
    parent's chunk entry without being serialized, encoded or sha-hashed
    on host — dirty detection costs a device reduction plus a tiny host
    compare instead of a full host re-hash of every leaf per round.
  * delta codecs — dirty chunks are run through a per-leaf codec
    (``repro_torch.checkpoint.codecs``; only ``none`` is ported so far)
    before storage, so the wire carries the *encoded* bytes.  Parent-
    relative codecs record the image (``pim``) they encoded against;
    pulls invert the codec chain back to raw bytes.

Every push/pull returns a byte report distinguishing raw payload bytes
from wire (encoded) bytes; the cluster runtime charges virtual-clock
transfer time from the wire bytes plus a configurable codec/fingerprint
compute cost.  Pulls can be told which chunks the puller already holds
(``have_chunks``) so a node that prefetched the parent image pays only
for the delta.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.checkpoint import codecs as _codecs
from repro_torch.checkpoint.fingerprint import leaf_fingerprints

CHUNK_BYTES = 4 * 1024 * 1024

CompressionSpec = Union[str, Dict[str, str]]


@dataclasses.dataclass
class PushReport:
    image_id: str
    total_bytes: int    # raw payload bytes across all chunks
    written_bytes: int  # encoded bytes newly written to the store (dedup'd)
    deduped_bytes: int  # raw bytes the store already held (saved vs cold)
    num_chunks: int
    parent_id: Optional[str] = None
    # raw bytes of chunks absent from the parent image (== total_bytes for
    # a full push): the dirty set a client holding the parent must move
    delta_bytes: int = -1
    # encoded bytes of that dirty set: what actually crosses the wire
    wire_bytes: int = -1
    codec: str = "none"          # the compression spec this push ran with
    lossy: bool = False          # any chunk used a lossy codec
    enc_raw_bytes: int = 0       # raw bytes fed through a codec encoder
    fp_bytes: int = 0            # raw bytes fingerprinted on device
    fp_clean_chunks: int = 0     # chunks proven clean by fingerprint alone

    def __post_init__(self):
        if self.delta_bytes < 0:
            self.delta_bytes = self.total_bytes
        if self.wire_bytes < 0:
            self.wire_bytes = self.delta_bytes


class ChunkStore:
    """Content-addressed blob store (filesystem-backed, thread-safe)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "chunks"), exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, "chunks", key[:2], key)

    def has(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def put(self, data: bytes) -> Tuple[str, bool]:
        """-> (key, newly_written)."""
        key = hashlib.sha256(data).hexdigest()
        path = self._path(key)
        with self._lock:
            if os.path.exists(path):
                return key, False
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)  # atomic
        return key, True

    def get(self, key: str) -> bytes:
        with open(self._path(key), "rb") as f:
            return f.read()


def _resolve_dtype(name: str):
    try:
        return np.dtype(name)
    except TypeError:
        import ml_dtypes
        return np.dtype(getattr(ml_dtypes, name))


def _leaf_meta(leaf) -> Tuple[str, Tuple[int, ...], int]:
    """(dtype name, shape, nbytes) without forcing a device->host copy.
    Tensor dtypes take numpy's names (``torch.float32`` -> ``float32``)."""
    if isinstance(leaf, torch.Tensor):
        return (str(leaf.dtype).removeprefix("torch."), tuple(leaf.shape),
                leaf.numel() * leaf.element_size())
    if isinstance(leaf, np.ndarray):
        return leaf.dtype.name, tuple(leaf.shape), int(leaf.nbytes)
    arr = np.asarray(leaf)
    return arr.dtype.name, tuple(arr.shape), int(arr.nbytes)


def _leaf_raw(leaf) -> bytes:
    """C-order raw bytes of the leaf (device->host transfer happens here,
    and only for leaves with at least one dirty chunk)."""
    if isinstance(leaf, torch.Tensor):
        # a byte view: bfloat16 has no numpy dtype, and .numpy() of it fails
        flat = leaf.detach().contiguous().reshape(-1)
        return flat.view(torch.uint8).cpu().numpy().tobytes()
    return np.asarray(leaf).tobytes()


class Registry:
    """The artifact registry: named state trees -> immutable images."""

    def __init__(self, root: str, chunk_bytes: Optional[int] = None):
        self.store = ChunkStore(root)
        self.root = root
        self.chunk_bytes = chunk_bytes or CHUNK_BYTES
        os.makedirs(os.path.join(root, "manifests"), exist_ok=True)
        self._tags: Dict[str, str] = {}
        self._manifests: Dict[str, dict] = {}  # immutable => cache forever
        self._lock = threading.Lock()

    # -- push ---------------------------------------------------------------
    def _parent_leaf(self, parent_manifest: Optional[dict], name: str,
                     i: int, dtype: str, shape, nbytes: int
                     ) -> Optional[dict]:
        """The parent's matching leaf entry, iff its chunk grid is
        compatible (same chunk_bytes + dtype/shape/nbytes => same chunk
        count/sizes)."""
        if (parent_manifest is None
                or parent_manifest.get("chunk_bytes") != self.chunk_bytes):
            return None
        spec = parent_manifest["trees"].get(name)
        if spec is None or i >= len(spec["leaves"]):
            return None
        ent = spec["leaves"][i]
        if (ent["dtype"] != dtype or tuple(ent["shape"]) != tuple(shape)
                or ent["nbytes"] != nbytes):
            return None
        return ent

    def _push(self, trees: Dict[str, Any], meta: Optional[dict],
              tag: Optional[str], parent: Optional[str], *,
              compression: CompressionSpec = "none",
              lossy_ok: bool = False,
              fingerprints: bool = True) -> PushReport:
        _codecs.validate_compression(compression)
        parent_manifest = self._manifest(parent) if parent else None
        parent_keys = (set(self.image_chunks(parent))
                       if parent is not None else set())
        cb = self.chunk_bytes
        total = written = written_raw = delta = wire = n_chunks = 0
        enc_raw = fp_bytes = fp_clean = 0
        parent_raw_memo: Dict[tuple, bytes] = {}
        lossy = False
        manifest: Dict[str, Any] = {"version": 2, "trees": {},
                                    "meta": meta or {}, "parent": parent,
                                    "chunk_bytes": cb}
        for name, tree in trees.items():
            leaves, treedef = _tree.flatten(tree)
            leaf_entries: List[dict] = []
            for i, leaf in enumerate(leaves):
                dtype, shape, nbytes = _leaf_meta(leaf)
                n = -(-nbytes // cb) if nbytes else 0
                pleaf = self._parent_leaf(parent_manifest, name, i,
                                          dtype, shape, nbytes)
                codec_name = _codecs.resolve_compression(
                    compression, name, _resolve_dtype(dtype),
                    pleaf is not None, lossy_ok, chunk_bytes=cb)
                fps = leaf_fingerprints(leaf, cb) if fingerprints else None
                if fps is not None:
                    fp_bytes += nbytes
                fp_list = (None if fps is None
                           else [[int(w) for w in row] for row in fps])
                pfps = pleaf.get("fps") if pleaf is not None else None
                clean = [False] * n
                if fp_list is not None and pfps is not None and len(pfps) == n:
                    # a null parent fingerprint marks a lossily-encoded
                    # chunk (its decode differs from what was pushed):
                    # never treat it as clean
                    clean = [fp_list[c] is not None
                             and fp_list[c] == pfps[c] for c in range(n)]

                total += nbytes
                n_chunks += n
                chunks: List[dict] = []
                if all(clean) and n:
                    # device fingerprints prove the whole leaf untouched:
                    # reuse the parent's entries without serializing it
                    fp_clean += n
                    chunks = [dict(ch) for ch in pleaf["chunks"]]
                else:
                    data = _leaf_raw(leaf) if nbytes else b""
                    codec = _codecs.get_codec(codec_name)
                    for c in range(n):
                        seg_len = min(cb, nbytes - c * cb)
                        if clean[c]:
                            fp_clean += 1
                            chunks.append(dict(pleaf["chunks"][c]))
                            continue
                        entry = {"raw": seg_len}
                        if codec_name == "none":
                            blob = data[c * cb: (c + 1) * cb]
                        else:
                            parent_raw = self._chunk_raw(
                                parent, name, i, c, memo=parent_raw_memo)
                            blob = codec.encode(
                                data[c * cb: (c + 1) * cb],
                                parent_raw, _resolve_dtype(dtype))
                            enc_raw += seg_len
                            if len(blob) >= seg_len:
                                # incompressible: store raw
                                blob = data[c * cb: (c + 1) * cb]
                            else:
                                entry["enc"] = codec_name
                                entry["pim"] = parent
                                if not codec.lossless:
                                    lossy = True
                                    # the image decodes to the *lossy*
                                    # reconstruction: the pushed leaf's
                                    # fingerprint would misrepresent it
                                    if fp_list is not None:
                                        fp_list[c] = None
                        key, new = self.store.put(blob)
                        entry["key"] = key
                        entry["wire"] = len(blob)
                        if new:
                            written += len(blob)
                            written_raw += seg_len
                        if key not in parent_keys:
                            delta += seg_len
                            wire += len(blob)
                            parent_keys.add(key)  # count shared chunks once
                        chunks.append(entry)
                leaf_entries.append({"dtype": dtype, "shape": list(shape),
                                     "nbytes": nbytes, "chunks": chunks,
                                     "fps": fp_list})
            manifest["trees"][name] = {
                "treedef": treedef,
                "leaves": leaf_entries,
            }
        blob = json.dumps(manifest, sort_keys=True).encode()
        image_id = hashlib.sha256(blob).hexdigest()[:24]
        path = os.path.join(self.root, "manifests", image_id + ".json")
        if not os.path.exists(path):
            with open(path + ".tmp", "wb") as f:
                f.write(blob)
            os.replace(path + ".tmp", path)
        if tag:
            with self._lock:
                self._tags[tag] = image_id
        spec_str = (json.dumps(compression, sort_keys=True)
                    if isinstance(compression, dict) else compression)
        # dedup savings stay in RAW units (total is raw; written is
        # encoded): raw bytes whose chunks the store already held
        return PushReport(image_id, total, written, total - written_raw,
                          n_chunks,
                          parent_id=parent,
                          delta_bytes=delta if parent is not None else total,
                          wire_bytes=wire if parent is not None else total,
                          codec=spec_str, lossy=lossy, enc_raw_bytes=enc_raw,
                          fp_bytes=fp_bytes, fp_clean_chunks=fp_clean)

    def push_image(self, trees: Dict[str, Any], meta: Optional[dict] = None,
                   tag: Optional[str] = None, *,
                   fingerprints: bool = True) -> PushReport:
        return self._push(trees, meta, tag, parent=None,
                          fingerprints=fingerprints)

    def push_delta(self, trees: Dict[str, Any], parent_image_id: str,
                   meta: Optional[dict] = None,
                   tag: Optional[str] = None, *,
                   compression: CompressionSpec = "none",
                   exact: bool = False,
                   fingerprints: bool = True) -> PushReport:
        """Delta push: the manifest still lists *every* chunk, but the wire
        cost — and the report's ``delta_bytes``/``wire_bytes`` — covers
        only chunks absent from the parent image.  ``compression`` selects
        the per-leaf delta codec; ``exact=True`` restricts the choice to
        lossless codecs (the pre-copy engine's final flush).

        Immutability caveat: with ``compression="none"`` the image is
        fully self-contained, but a codec-encoded chunk decodes against
        the image it was encoded against (its ``pim`` entry) — the delta
        image pins its parent lineage, so GC/export must keep the chain
        reachable (``delta_chain``)."""
        return self._push(trees, meta, tag, parent=parent_image_id,
                          compression=compression, lossy_ok=not exact,
                          fingerprints=fingerprints)

    # -- pull ---------------------------------------------------------------
    def _manifest(self, image_id: str) -> dict:
        """Manifests are content-addressed (immutable), so a restore's
        pull/chunk-map/meta triple parses the file once, not three times."""
        cached = self._manifests.get(image_id)
        if cached is not None:
            return cached
        path = os.path.join(self.root, "manifests", image_id + ".json")
        with open(path, "rb") as f:
            manifest = json.loads(f.read())
        if manifest.get("version") != 2:
            raise ValueError(
                f"image {image_id} has manifest version "
                f"{manifest.get('version', 1)}; this registry reads "
                f"version 2 (re-push the state with the current code)")
        with self._lock:
            self._manifests[image_id] = manifest
        return manifest

    def _chunk_raw(self, image_id: str, name: str, li: int, ci: int,
                   charge: Optional[Callable[[str, int], None]] = None,
                   memo: Optional[Dict[tuple, bytes]] = None) -> bytes:
        """Raw bytes of one chunk, inverting the codec chain (an encoded
        chunk decodes against the image it was encoded against, ``pim``).
        ``charge`` is called once per touched chunk for wire accounting;
        ``memo`` (scoped to one push/pull) keeps repeated walks over a
        shared parent chain linear instead of O(chain^2)."""
        mkey = (image_id, name, li, ci)
        if memo is not None and mkey in memo:
            return memo[mkey]
        ent = self._manifest(image_id)["trees"][name]["leaves"][li]
        dtype, ent = ent["dtype"], ent["chunks"][ci]
        blob = self.store.get(ent["key"])
        if charge is not None:
            charge(ent["key"], ent["wire"])
        enc = ent.get("enc", "none")
        if enc == "none":
            raw = blob
        else:
            parent_raw = self._chunk_raw(ent["pim"], name, li, ci, charge,
                                         memo)
            raw = _codecs.get_codec(enc).decode(blob, parent_raw,
                                                _resolve_dtype(dtype))
        if memo is not None:
            memo[mkey] = raw
        return raw

    def pull_image(self, image_id: str,
                   have_chunks: Optional[set] = None
                   ) -> Tuple[Dict[str, Any], int]:
        """-> (trees of numpy leaves, wire_bytes_pulled).

        With ``have_chunks`` (the puller's local chunk cache), only missing
        chunks are charged.  Accounting is per distinct chunk — each chunk
        crosses the wire at most once per pull regardless of how many
        leaves reference it — and covers the decode chain too: a delta
        chunk whose codec parents were never prefetched pays for them."""
        manifest = self._manifest(image_id)
        trees = {}
        pulled = 0
        seen = set(have_chunks or ())
        memo: Dict[tuple, bytes] = {}

        def charge(key: str, wire: int):
            nonlocal pulled
            if key not in seen:
                pulled += wire
                seen.add(key)

        for name, spec in manifest["trees"].items():
            leaves = []
            for li, entry in enumerate(spec["leaves"]):
                data = b"".join(
                    self._chunk_raw(image_id, name, li, ci, charge, memo)
                    for ci in range(len(entry["chunks"])))
                arr = np.frombuffer(data, dtype=_resolve_dtype(entry["dtype"]))
                leaves.append(arr.reshape(entry["shape"]).copy())
            trees[name] = _tree.unflatten(spec["treedef"], leaves)
        return trees, pulled

    def image_chunks(self, image_id: str) -> Dict[str, int]:
        """Chunk key -> stored (wire) byte size for every chunk of the
        image."""
        manifest = self._manifest(image_id)
        out: Dict[str, int] = {}
        for spec in manifest["trees"].values():
            for entry in spec["leaves"]:
                for ch in entry["chunks"]:
                    out[ch["key"]] = ch["wire"]
        return out

    def image_parent(self, image_id: str) -> Optional[str]:
        return self._manifest(image_id).get("parent")

    def delta_chain(self, image_id: str) -> List[str]:
        """Forensic lineage: [image_id, parent, grandparent, ...]."""
        chain = [image_id]
        while True:
            parent = self.image_parent(chain[-1])
            if parent is None:
                return chain
            chain.append(parent)

    def image_meta(self, image_id: str) -> dict:
        return self._manifest(image_id)["meta"]

    def resolve(self, tag: str) -> Optional[str]:
        with self._lock:
            return self._tags.get(tag)

    def list_images(self) -> List[str]:
        d = os.path.join(self.root, "manifests")
        return sorted(p[:-5] for p in os.listdir(d) if p.endswith(".json"))

    # -- deletion / garbage collection ----------------------------------------
    def delete_image(self, image_id: str) -> bool:
        """Remove an image's manifest (and any tags resolving to it).
        Chunks are shared content-addressed blobs — reclaim orphans with
        :meth:`gc` afterwards.  Returns True if the manifest existed.

        A codec-encoded delta image decodes against its parent chain, so
        deleting a parent that *other* images still reference breaks
        them; callers must only delete whole lineages they own (the
        migration rollback deletes exactly the images one failed attempt
        pushed, newest first)."""
        path = os.path.join(self.root, "manifests", image_id + ".json")
        with self._lock:
            self._manifests.pop(image_id, None)
            for tag in [t for t, i in self._tags.items() if i == image_id]:
                del self._tags[tag]
        if os.path.exists(path):
            os.remove(path)
            return True
        return False

    def gc(self) -> Tuple[int, int]:
        """Mark-and-sweep chunk collection: delete every stored chunk no
        remaining manifest references (the storage of half-pushed images
        a rollback deleted).  Returns (chunks_deleted, bytes_freed)."""
        live: set = set()
        for image_id in self.list_images():
            live.update(self.image_chunks(image_id))
        chunks_root = os.path.join(self.root, "chunks")
        deleted = freed = 0
        for sub in sorted(os.listdir(chunks_root)):
            subdir = os.path.join(chunks_root, sub)
            if not os.path.isdir(subdir):
                continue
            for key in sorted(os.listdir(subdir)):
                if key.endswith(".tmp") or key in live:
                    continue
                path = os.path.join(subdir, key)
                freed += os.path.getsize(path)
                os.remove(path)
                deleted += 1
        return deleted, freed
