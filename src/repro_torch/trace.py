"""Spans and byte counters of the port's hot paths, kept in memory.

Off by default.  ``span(name, nbytes)`` is a context manager placed
where the work happens (the serving engine's step, the trainer's step
and its forward, backward and optimizer, each phase of a registry push
and pull, a worker's checkpoint and restore).  While tracing is off it
returns one shared no-op object after a single check of a module flag:
no allocation, no clock read, no profiler range.

``enable(clock)`` turns it on: each span then records ``Span(name, id,
parent, thread, t0, t1, nbytes)`` on ``clock`` (seconds), its parent the
innermost span open on the same thread, and adds its bytes to a total by
name.  While a ``torch.profiler`` profile runs, each span also opens a
``record_function`` range of the same name, which puts it on the
profile's timeline next to the device's operations.  ``spans()`` hands
out what was recorded and forgets it; ``counters()`` reads the byte
totals and the kernels' own launch counters.

Names, every one under ``repro_torch.``:

* ``engine.step`` (``ServingEngine._engine_step``) holds ``engine.dispatch``
  (the decode step's launches, up to the next tokens on the device) and
  ``engine.sync`` (the wait for them on the host); ``engine.state_tree``
  and ``engine.load_state`` copy the cache (its bytes).
* ``trainer.step`` (``TrainerWorker.process``) holds ``trainer.dispatch``
  (the batch to the device and the step's launches: ``train.forward``,
  ``train.backward``, ``train.optimizer``) and ``trainer.sync`` (the wait
  for the loss); ``trainer.state_tree`` and ``trainer.load_state`` copy
  the params and the AdamW state (their bytes).
* ``registry.push`` and ``registry.pull`` (an image's bytes) hold, a leaf
  at a time, ``registry.fingerprint`` (its device fingerprints),
  ``registry.d2h`` (its bytes off its device), ``registry.hash`` (the
  sha256 of its dirty chunks), ``registry.put`` (its chunks into the
  store, the bytes handed over), ``registry.get`` (its chunks read and
  decoded) and ``registry.assemble`` (copied into one host array);
  ``registry.place`` (a leaf's bytes), inside ``registry.assemble``, is
  open only for a leaf of two or more chunks, whose copies run on the
  registry's thread pool.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.tree import leaves


class Span(NamedTuple):
    name: str
    id: int
    parent: int      # the enclosing span's id on the same thread, 0 at top
    thread: int      # threading.get_ident() of the thread that ran it
    t0: float
    t1: float
    nbytes: int


class _NoSpan:
    """What ``span`` returns while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def add(self, nbytes: int) -> None:
        pass


NO_SPAN = _NoSpan()

_on = False
_clock: Callable[[], float] = time.perf_counter
_ids = itertools.count(1)
_local = threading.local()
_done: List[Span] = []
_bytes: Dict[str, int] = {}
_lock = threading.Lock()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("name", "nbytes", "id", "parent", "t0", "_range")

    def __init__(self, name: str, nbytes: int):
        self.name, self.nbytes = name, int(nbytes)

    def add(self, nbytes: int) -> None:
        """Count ``nbytes`` more to this span (bytes known only as it runs)."""
        self.nbytes += int(nbytes)

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else 0
        self.id = next(_ids)
        stack.append(self)
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = _clock()
        if self._range is not None:
            self._range.__exit__(*exc)
        _stack().pop()
        _done.append(Span(self.name, self.id, self.parent,
                          threading.get_ident(), self.t0, t1, self.nbytes))
        with _lock:
            _bytes[self.name] = _bytes.get(self.name, 0) + self.nbytes
        return False


def span(name: str, nbytes: int = 0):
    """A span of ``name`` (``repro_torch.<layer>.<phase>``) carrying
    ``nbytes``; the shared no-op while tracing is off."""
    if not _on:
        return NO_SPAN
    return _Span(name, nbytes)


def enable(clock: Callable[[], float] = time.perf_counter) -> None:
    """Record spans from now on, timed by ``clock`` (seconds)."""
    global _on, _clock
    _clock = clock
    _on = True


def disable() -> None:
    """Record no more spans (those open finish recording)."""
    global _on
    _on = False


def current() -> Optional[str]:
    """The innermost span open on this thread, or None."""
    stack = _stack()
    return stack[-1].name if stack else None


def spans() -> List[Span]:
    """The spans recorded so far, in the order they ended; forgets them."""
    out = _done[:]
    del _done[:len(out)]
    return out


def counters() -> Dict[str, Dict[str, int]]:
    """``{"bytes": span name -> bytes recorded under it, "launches":
    kernel -> wrapper calls that launched it}``: the byte totals since the
    process started (only while tracing was on), and the kernel modules'
    own ``LAUNCHES`` counters, read where they are."""
    from repro_torch.kernels import (codec, decode_attention, fingerprint,
                                     flash_attention, mlstm, rglru, slstm)

    with _lock:
        nbytes = dict(_bytes)
    launches = {
        "decode_attention": decode_attention.LAUNCHES,
        "flash_attention": flash_attention.LAUNCHES,
        "flash_attention.wgmma": flash_attention.WGMMA_LAUNCHES,
        "flash_attention.tf32x3": flash_attention.TF32X3_LAUNCHES,
        "fingerprint_lanes": fingerprint.LAUNCHES,
        "rglru": rglru.LAUNCHES,
        "slstm": slstm.LAUNCHES,
        "slstm.cluster": slstm.CLUSTER_LAUNCHES,
        "mlstm": mlstm.LAUNCHES,
        "mlstm.wgmma": mlstm.WGMMA_LAUNCHES,
    }
    launches.update(codec.LAUNCHES)
    return {"bytes": nbytes, "launches": launches}


def tree_bytes(tree) -> int:
    """The bytes of a tree's tensor and array leaves."""
    n = 0
    for x in leaves(tree):
        n += (x.numel() * x.element_size() if isinstance(x, torch.Tensor)
              else np.asarray(x).nbytes)
    return n
