"""Thread-safe admission queue with priority ordering and deadline sweep
(a copy of the JAX package's ``serve/queue.py``).

The queue holds :class:`Ticket`\\ s — a request plus its future, arrival
order, absolute deadline, pre-tokenized ids, and compatibility key — and
implements the max-wait/max-batch admission policy: ``pop_group`` blocks
for the highest-priority head ticket, then coalesces every compatible
ticket (same :mod:`.coalescer` key) up to ``max_batch``, launching early
only when the head has already waited ``max_wait_s``.  Deadline-expired
tickets are swept out and RETURNED to the caller (the scheduler rejects
them with the typed :class:`~.request.DeadlineExceeded`) — they are
never silently dropped inside the queue.

Capacity is a hard bound enforced at ``put`` (typed
:class:`~.request.QueueFull`); split micro-batches re-entering after an
OOM go through ``requeue`` which bypasses the bound — those rows were
already admitted once and dropping them on re-entry would lose work.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, List, Optional, Tuple

from .request import QueueFull, SchedulerClosed, ScoreFuture, ScoreRequest


@dataclasses.dataclass
class Ticket:
    """One admitted request travelling through the scheduler."""

    request: ScoreRequest
    future: ScoreFuture
    seq: int                        # admission order (FIFO tie-break)
    enqueue_t: float                # monotonic submit time
    deadline: Optional[float]       # absolute monotonic, None = never
    encoded: Any = None             # token ids (or (prefix_ids, suffix_ids))
    key: Any = None                 # coalescer compatibility key
    degraded: Optional[int] = None  # engine batch override after OOM splits
    trace_id: Optional[str] = None  # obs/ request-scoped span correlation
                                    # id (set at submit when tracing is on;
                                    # threads queue-wait/engine/respond
                                    # spans and the result row together)
    queue_wait_s: Optional[float] = None  # latency-anatomy stamps set at
    coalesce_s: Optional[float] = None    # launch (scheduler.HIST_PHASES)

    def sort_key(self) -> Tuple[int, int]:
        return (-self.request.priority, self.seq)

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline


class RequestQueue:
    def __init__(self, capacity: int):
        self.capacity = max(1, int(capacity))
        self._items: List[Ticket] = []
        self._cond = threading.Condition()
        self._closed = False

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)

    def put(self, ticket: Ticket) -> None:
        with self._cond:
            if self._closed:
                raise SchedulerClosed("scheduler is shut down")
            if len(self._items) >= self.capacity:
                raise QueueFull(
                    f"admission queue at capacity ({self.capacity})")
            self._items.append(ticket)
            self._cond.notify_all()

    def requeue(self, tickets: List[Ticket]) -> None:
        """Re-admit split micro-batch tickets (OOM re-entry): original
        ``seq`` values are preserved, so they sort ahead of traffic that
        arrived after them; the capacity bound does not apply."""
        with self._cond:
            self._items.extend(tickets)
            self._cond.notify_all()

    def close(self) -> None:
        """Stop admitting; ``pop_group`` keeps draining what is queued
        and returns ``None`` once empty."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def wake(self) -> None:
        """Nudge a blocked ``pop_group`` so it re-checks its caller's
        ``ready_fn`` — how the decode-role scheduler learns a KV slab
        landed while its loop sat in the empty-queue wait (slab work must
        run ON the loop thread; the engine is single-threaded)."""
        with self._cond:
            self._cond.notify_all()

    def drain(self) -> List[Ticket]:
        """Remove and return EVERY queued ticket without closing the
        queue.  The supervisor's failover path (serve/supervisor.py)
        reclaims a quarantined replica's queued-but-unlaunched tickets
        this way so they re-enter the pool's per-model queue instead of
        dying with the replica."""
        with self._cond:
            items, self._items = self._items, []
            return items

    def oldest_wait_s(self, now_fn=time.monotonic) -> Optional[float]:
        """Age of the OLDEST queued ticket in seconds (None when empty).
        The /healthz degraded condition reads this: queue depth alone
        cannot distinguish a short queue that is draining from a short
        queue behind a wedged coalescer — the head request's age can."""
        with self._cond:
            if not self._items:
                return None
            return now_fn() - min(t.enqueue_t for t in self._items)

    def pop_compatible(self, key, max_n: int,
                       now_fn=time.monotonic) -> List[Ticket]:
        """NON-BLOCKING pop of up to ``max_n`` live tickets whose
        coalescer key matches ``key`` — the slot-admission path
        (scheduler._launch's mid-decode refill hook): a vacated decode
        slot pulls freshly-queued compatible traffic without waiting for
        the coalescer boundary.  Deadline-expired tickets are left in
        place for ``pop_group``'s sweep (one rejection path, not two)."""
        with self._cond:
            now = now_fn()
            out: List[Ticket] = []
            for t in sorted(self._items, key=Ticket.sort_key):
                if len(out) >= max(1, max_n):
                    break
                if t.key == key and not t.expired(now):
                    out.append(t)
            for t in out:
                self._items.remove(t)
            return out

    def pop_group(self, max_batch: int, max_wait_s: float,
                  now_fn=time.monotonic, ready_fn=None
                  ) -> Tuple[Optional[List[Ticket]], List[Ticket]]:
        """``(group, expired)``: the next launchable micro-batch plus the
        tickets whose deadline passed while queued.  ``group`` is ``None``
        exactly when the queue is closed and drained.

        ``ready_fn`` is the out-of-band work probe (paired with
        :meth:`wake`): when it returns true the pop yields ``([],
        expired)`` immediately so the loop thread can service that work —
        an EMPTY group, distinct from the closed ``None`` — and the held
        head ticket keeps its enqueue-time-based max-wait accounting on
        the next call."""
        expired: List[Ticket] = []
        with self._cond:
            while True:
                now = now_fn()
                live: List[Ticket] = []
                for t in self._items:
                    (expired if t.expired(now) else live).append(t)
                self._items = live
                if ready_fn is not None and ready_fn():
                    return [], expired
                if not live:
                    if self._closed:
                        return None, expired
                    if expired:
                        # surface rejections promptly instead of holding
                        # them until the next arrival
                        return [], expired
                    self._cond.wait(timeout=0.05)
                    continue
                head = min(live, key=Ticket.sort_key)
                group = [t for t in sorted(live, key=Ticket.sort_key)
                         if t.key == head.key][: max(1, max_batch)]
                full = len(group) >= max(1, max_batch)
                waited = now - head.enqueue_t
                if full or self._closed or waited >= max_wait_s:
                    for t in group:
                        self._items.remove(t)
                    return group, expired
                if expired:
                    return [], expired
                self._cond.wait(timeout=max(0.001, max_wait_s - waited))
