"""In-process message broker with MS2M's secondary-queue semantics.

RabbitMQ analogue (the paper's inter-service fabric), as a library:
  * named FIFO queues with monotonically increasing per-queue message ids
    (the id order is what makes replay well-defined);
  * *secondary queues*: ``attach_secondary(primary)`` mirrors every publish
    on the primary into a migration buffer from that instant — the MS2M
    accumulation mechanism (paper §II, §III-B);
  * consumer waiting via sim Conditions (no busy polling);
  * per-instance dedicated queues for StatefulSet workers (paper §III-C).

The broker is deliberately time-free: all timing lives in the cluster
runtime; the broker only orders and stores.

Fleet-scale addition (docs/scaling.md): a queue may own an *arrival
source* (:meth:`MessageQueue.attach_source`) — a draw function yielding
``(gap_s, payload)`` pairs.  With ``Sim.fluid_enabled`` the source is
drawn in batches and arrivals are materialized lazily at observation
points (:meth:`MessageQueue.sync`), with closed-form id/time assignment
that reproduces the per-event producer bit-for-bit; with
``REPRO_SIM_FLUID=0`` the source degrades to a per-arrival pump process
whose event and RNG sequences are identical to the legacy inline
producer generators.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional

if TYPE_CHECKING:  # annotation-only: avoids the broker <-> cluster cycle
    from repro_torch.cluster.sim import Condition, Sim


@dataclasses.dataclass
class Message:
    msg_id: int
    payload: Any
    publish_time: float


class _ArrivalSource:
    """Batched arrival drawing for one queue.

    ``draw()`` returns ``(gap_s, payload)`` or ``None`` (source exhausted).
    Arrival times accumulate exactly like the legacy producer event loop:
    ``t_k = t_{k-1} + float(gap_k)`` starting from the sim clock at attach
    — the identical float additions the kernel performed in ``_step``, so
    lazily assigned publish times are bit-identical to eager ones.
    """

    __slots__ = ("draw", "on_publish", "pending", "head_t", "closed",
                 "pumped")

    def __init__(self, draw: Callable[[], Optional[tuple]],
                 on_publish: Optional[Callable[[Message], None]],
                 start_t: float):
        self.draw = draw
        self.on_publish = on_publish
        self.pending: deque = deque()  # (arrival_t, payload), ascending
        self.head_t = start_t
        self.closed = False
        # pump mode (REPRO_SIM_FLUID=0): a per-arrival process owns the
        # draws — the batched machinery (ensure_drawn/next_arrival/halt
        # trimming) must never touch the stream
        self.pumped = False

    def ensure_drawn(self, horizon: float) -> None:
        """Draw arrivals until the next undrawn one lies past ``horizon``.
        The overshooting arrival (first > horizon) stays pending — the
        legacy producer also had exactly one in-flight arrival drawn.
        Fluid folds bypass this (they draw-and-consume in one loop); it
        serves observers materializing a backlog outside a fold."""
        if self.closed:
            return
        draw = self.draw
        append = self.pending.append
        head_t = self.head_t
        while head_t <= horizon:
            item = draw()
            if item is None:
                self.closed = True
                break
            gap, payload = item
            head_t = head_t + float(gap)
            append((head_t, payload))
        self.head_t = head_t

    def next_arrival(self) -> Optional[float]:
        """Arrival time of the next pending message, drawing one if
        needed; ``None`` when the source is exhausted."""
        if not self.pending:
            if self.closed:
                return None
            item = self.draw()
            if item is None:
                self.closed = True
                return None
            gap, payload = item
            self.head_t = self.head_t + float(gap)
            self.pending.append((self.head_t, payload))
        return self.pending[0][0]

    def halt(self, now: float) -> None:
        """Stop-flag semantics of the legacy producer: every arrival
        <= ``now`` is kept, plus exactly the first one after ``now`` (the
        producer always had one drawn in-flight sleep that still lands),
        then the source closes.  Over-drawn RNG values beyond that are
        unobservable — each producer owns its generator."""
        if self.closed and not self.pending:
            return
        keep: deque = deque()
        extra_kept = False
        for t, payload in self.pending:
            if t <= now:
                keep.append((t, payload))
            elif not extra_kept:
                keep.append((t, payload))
                extra_kept = True
        if not extra_kept and not self.closed:
            item = self.draw()
            if item is not None:
                gap, payload = item
                self.head_t = self.head_t + float(gap)
                keep.append((self.head_t, payload))
        self.pending = keep
        self.closed = True


class MessageQueue:
    def __init__(self, name: str, sim: Sim):
        self.name = name
        self.sim = sim
        self._items: deque = deque()
        self._next_id = itertools.count()
        self._not_empty: Optional[Condition] = None
        # pooled, permanently-triggered "items visible" condition: steady
        # consumption must not churn a fresh Condition per message
        self._ready: Optional[Condition] = None
        self.total_published = 0
        # broker_stall fault: a stalled queue accepts publishes but delivers
        # nothing until unstalled (a wedged consumer channel) — no loss,
        # only delay
        self.stalled = False
        # fluid machinery (docs/scaling.md): arrival source, mirror sinks
        # fed at materialization time, back-reference from a mirror to its
        # primary (so observing the mirror materializes the primary first),
        # the consuming pod's fold hook, and the armed next-arrival timer
        self._source: Optional[_ArrivalSource] = None
        self._mirror_sinks: List["MessageQueue"] = []
        self._primary_ref: Optional["MessageQueue"] = None
        self._consumer_sync: Optional[Callable[[float], None]] = None
        self._timer_t: Optional[float] = None

    # arrival sources ------------------------------------------------------
    def attach_source(self, draw: Callable[[], Optional[tuple]],
                      on_publish: Optional[Callable[[Message], None]] = None
                      ) -> None:
        """Feed this queue from a draw function returning ``(gap_s,
        payload)`` per arrival (``None`` = exhausted).  Replaces the
        inline producer-process idiom; see module docstring for the two
        execution modes."""
        if self._source is not None:
            raise RuntimeError(f"queue {self.name!r} already has a source")
        self._source = _ArrivalSource(draw, on_publish, self.sim.now)
        if not self.sim.fluid_enabled:
            self._source.pumped = True
            self.sim.process(self._pump(), name=f"source:{self.name}")

    def halt_source(self) -> None:
        """Close the source with legacy stop-flag trimming (arrivals
        <= now plus the single in-flight one still land)."""
        src = self._source
        if src is None:
            return
        if src.pumped:
            # the pump publishes its one in-flight arrival at wake, sees
            # the closed flag and exits — exactly the legacy stop flag
            src.closed = True
            return
        self.sync(self.sim.now)
        src.halt(self.sim.now)

    def _pump(self):
        """Per-arrival pump used when fluid mode is off: event sequence,
        RNG call order and stop semantics identical to the legacy inline
        producer generators (publish, then re-check the stop condition)."""
        src = self._source
        while True:
            if src.closed:
                return
            item = src.draw()
            if item is None:
                src.closed = True
                return
            gap, payload = item
            yield float(gap)
            self._materialize(self.sim.now, payload)

    def sync(self, now: float) -> None:
        """Materialize every deferred observable effect up to ``now``:
        fold the consuming pod's fluid plan, then publish all source
        arrivals <= ``now`` (ids, mirror copies, on_publish callbacks) in
        order.  Called by every observation point — after it returns, the
        queue state is bit-identical to the legacy eager timeline."""
        pr = self._primary_ref
        if pr is not None:
            pr.sync(now)
        hook = self._consumer_sync
        if hook is not None:
            hook(now)
        src = self._source
        if src is not None and not src.pumped:
            src.ensure_drawn(now)
            pend = src.pending
            while pend and pend[0][0] <= now:
                t, payload = pend.popleft()
                self._materialize(t, payload)

    def _materialize(self, t: float, payload: Any,
                     enqueue: bool = True) -> Message:
        """Assign the next id and publish an arrival stamped at its true
        arrival time ``t``.  ``enqueue=False`` is the fused
        materialize-and-consume path used by a fluid fold (the consumer
        takes the message in the same operation, so it never enters
        ``_items``)."""
        msg = Message(next(self._next_id), payload, t)
        if enqueue:
            self._push(msg)
        else:
            self.total_published += 1
        src = self._source
        if src is not None and src.on_publish is not None:
            src.on_publish(msg)
        for sec in self._mirror_sinks:
            # mirrored copy keeps the primary's message id (replay identity)
            sec._push(Message(msg.msg_id, payload, t))
        return msg

    def _arm_arrival_timer(self) -> None:
        """Wake a per-message-mode consumer at the next lazy arrival.
        Self-healing: a stale timer just syncs (a no-op) and the waiter
        re-arms on its next wait."""
        q = self
        src = self._source
        if src is None and self._primary_ref is not None:
            q = self._primary_ref
            src = q._source
        if src is None or src.pumped:
            return
        t = src.next_arrival()
        if t is None or self._timer_t == t:
            return
        self._timer_t = t

        def fire(q=q, t=t):
            if self._timer_t == t:
                self._timer_t = None
            q.sync(self.sim.now)

        self.sim.call_at(t, fire, category="message")

    # publishing ---------------------------------------------------------
    def publish(self, payload: Any) -> Message:
        self.sync(self.sim.now)
        msg = Message(next(self._next_id), payload, self.sim.now)
        self._push(msg)
        return msg

    def _push(self, msg: Message):
        self._items.append(msg)
        self.total_published += 1
        if self._not_empty is not None and not self.stalled:
            cond, self._not_empty = self._not_empty, None
            cond.trigger()

    # stalling (fault injection) ------------------------------------------
    def stall(self):
        self.sync(self.sim.now)
        self.stalled = True

    def unstall(self):
        self.stalled = False
        self.sync(self.sim.now)
        if self._items and self._not_empty is not None:
            cond, self._not_empty = self._not_empty, None
            cond.trigger()

    # consuming ----------------------------------------------------------
    def try_get(self) -> Optional[Message]:
        self.sync(self.sim.now)
        if self.stalled:
            return None
        return self._items.popleft() if self._items else None

    def peek_last_id(self) -> int:
        """Highest id ever published (-1 if none)."""
        self.sync(self.sim.now)
        return self.total_published - 1 if self.total_published else -1

    def wait_not_empty(self) -> Condition:
        self.sync(self.sim.now)
        if self._items and not self.stalled:
            if self._ready is None:
                self._ready = self.sim.condition(f"{self.name}:ready")
                self._ready.trigger()
            return self._ready
        if not self.stalled:
            self._arm_arrival_timer()
        if self._not_empty is None:
            self._not_empty = self.sim.condition(f"{self.name}:not_empty")
        return self._not_empty

    def depth(self) -> int:
        self.sync(self.sim.now)
        return len(self._items)

    def requeue_front(self, msg: Message):
        self._items.appendleft(msg)


class Broker:
    def __init__(self, sim: Sim):
        self.sim = sim
        self.queues: Dict[str, MessageQueue] = {}
        self._mirrors: Dict[str, List[str]] = {}

    def declare_queue(self, name: str) -> MessageQueue:
        if name not in self.queues:
            self.queues[name] = MessageQueue(name, self.sim)
            self._mirrors.setdefault(name, [])
        return self.queues[name]

    def publish(self, queue: str, payload: Any) -> Message:
        msg = self.queues[queue].publish(payload)
        for mirror in self._mirrors.get(queue, []):
            # mirrored copy keeps the primary's message id (replay identity)
            self.queues[mirror]._push(
                Message(msg.msg_id, payload, self.sim.now))
        return msg

    # MS2M secondary queues ------------------------------------------------
    def attach_secondary(self, primary: str, name: Optional[str] = None) -> MessageQueue:
        """Mirror the primary's unconsumed backlog and all future
        publishes into a new queue.

        Copying the backlog is a correctness requirement, not an
        optimization: the migration invariant is "checkpoint image plus
        mirror covers every id", and the image only covers what the
        *source has folded* by checkpoint time.  A source that is behind
        (e.g. just resumed after a rolled-back migration attempt) may
        checkpoint at a marker below ids that were already published
        before the mirror attached — without the backlog copies those ids
        would be in neither the image nor the mirror and the target would
        silently lose them.  Ids the image does cover are deduplicated at
        replay (the consumer skips ids <= the checkpoint marker), so the
        copies are free for a caught-up source — attaching on an empty
        backlog remains the seed behaviour, bit for bit."""
        primary_q = self.queues[primary]
        # attaching a mirror is a migration-relevant instant: fold the
        # fluid plan and materialize due arrivals before snapshotting the
        # backlog, and from here on the consumer runs per-message
        primary_q.sync(self.sim.now)
        sec_name = name or f"{primary}.secondary"
        sec = self.declare_queue(sec_name)
        for msg in primary_q._items:  # ascending id order
            sec._push(Message(msg.msg_id, msg.payload, msg.publish_time))
        self._mirrors[primary].append(sec_name)
        primary_q._mirror_sinks.append(sec)
        sec._primary_ref = primary_q
        if self.sim.sanitizer is not None:
            self.sim.sanitizer.check_listener_growth(
                f"broker mirror list of {primary!r}",
                len(self._mirrors[primary]))
        return sec

    def is_mirrored(self, primary: str, sec_name: str) -> bool:
        return sec_name in self._mirrors.get(primary, [])

    def detach_secondary(self, primary: str, sec_name: str):
        self._mirrors[primary].remove(sec_name)
        primary_q = self.queues[primary]
        sec = self.queues.get(sec_name)
        if sec is not None:
            if sec in primary_q._mirror_sinks:
                primary_q._mirror_sinks.remove(sec)
            sec._primary_ref = None

    def delete_queue(self, name: str):
        gone = self.queues.pop(name, None)
        self._mirrors.pop(name, None)
        for mirrors in self._mirrors.values():
            if name in mirrors:
                mirrors.remove(name)
        if gone is not None:
            for q in self.queues.values():
                if gone in q._mirror_sinks:
                    q._mirror_sinks.remove(gone)
