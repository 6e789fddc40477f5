"""Async periodic checkpointing + restart-with-journal-replay.

The FT story (1000+ nodes): every worker pushes an image every
``interval_steps``; on failure the controller restores latest image and
replays the message/batch journal since — i.e. recovery *is* MS2M's replay
path, so checkpoint frequency trades registry bandwidth against replay time
via exactly the paper's Eq. 5 (see core/cutoff.py:replay_time_bound).
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint.registry import PushReport, Registry
from repro_torch.tree import tree_map


class Checkpointer:
    def __init__(self, registry: Registry, name: str,
                 interval_steps: int = 100):
        self.registry = registry
        self.name = name
        self.interval_steps = interval_steps
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix=f"ckpt-{name}")
        self._latest: Optional[Tuple[int, str]] = None
        self._lock = threading.Lock()
        self._pending: Optional[Future] = None

    def maybe_save(self, step: int, trees: Dict[str, Any],
                   meta: Optional[dict] = None) -> Optional[Future]:
        if step % self.interval_steps != 0:
            return None
        return self.save(step, trees, meta)

    def save(self, step: int, trees: Dict[str, Any],
             meta: Optional[dict] = None, block: bool = False):
        # snapshot to host memory synchronously (cheap), push async; a copy
        # even for CPU tensors, which the caller may go on mutating
        host_trees = tree_map(
            lambda x: (x.detach().to("cpu", copy=True)
                       if isinstance(x, torch.Tensor) else x),
            trees)
        meta = dict(meta or {})
        meta["step"] = step
        meta["worker"] = self.name

        def _push() -> PushReport:
            report = self.registry.push_image(
                host_trees, meta, tag=f"{self.name}:latest")
            with self._lock:
                if self._latest is None or step >= self._latest[0]:
                    self._latest = (step, report.image_id)
            return report

        fut = self._pool.submit(_push)
        self._pending = fut
        if block:
            return fut.result()
        return fut

    def wait(self):
        if self._pending is not None:
            self._pending.result()

    def latest(self) -> Optional[Tuple[int, str]]:
        with self._lock:
            return self._latest

    def restore_latest(self) -> Optional[Tuple[int, Dict[str, Any]]]:
        latest = self.latest()
        if latest is None:
            return None
        step, image_id = latest
        trees, _ = self.registry.pull_image(image_id)
        return step, trees
