"""Typed request/future surface of the continuous-batching scheduler (a
copy of the JAX package's ``serve/request.py``).

A :class:`ScoreRequest` is one independent scoring question — a formatted
prompt (or a ``(prefix, suffix)`` pair that rides the engine's fused
prefix-reuse path), its yes/no target pair, the leg knobs the engine's
``GenerationPlan`` cache keys on (``with_confidence`` /
``max_new_tokens``), a priority, and an optional deadline.  ``submit``
returns a :class:`ScoreFuture` that resolves to the engine's ordinary
result-row dict (runtime/engine._result_row contract) or to one of the
TYPED errors below — a rejected request is always told WHY (deadline,
backpressure, shutdown), never silently dropped.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple


class ServeError(RuntimeError):
    """Base of every scheduler-raised error."""


class DeadlineExceeded(ServeError):
    """The request's deadline passed before its micro-batch launched."""


class QueueFull(ServeError):
    """Backpressure: the admission queue is at capacity.  Raised at
    ``submit`` time so the caller can shed load or retry — admission is
    never silently deferred past the queue bound."""


class SchedulerClosed(ServeError):
    """The scheduler shut down before (or while) the request could run."""


class PoisonousRequest(ServeError):
    """The same request took down multiple replicas (the supervisor's
    poison-row ceiling, serve/supervisor.py): after ``poison_kill_limit``
    replica crashes attributable to one request, it is rejected with this
    typed error instead of being failed over to — and killing — a third
    replica.  The caller learns the request itself is the hazard."""


@dataclasses.dataclass
class ScoreRequest:
    """One scoring request.

    Exactly one of ``prompt`` (a formatted prompt string or a
    pre-tokenized id list) or ``prefix``+``suffix`` (the fused
    prefix-reuse spelling — requests sharing a prefix coalesce into one
    ``score_prefixed`` batch and ride one ``PrefixCachePool`` entry per
    micro-batch).  ``timeout_s`` is relative to submit time; the
    scheduler converts it to an absolute monotonic deadline.  Higher
    ``priority`` launches first; FIFO within a priority level."""

    prompt: Any = None
    prefix: Any = None
    suffix: Any = None
    targets: Tuple[str, str] = ("Yes", "No")
    with_confidence: bool = False
    max_new_tokens: Optional[int] = None
    priority: int = 0
    timeout_s: Optional[float] = None
    #: joint K-token decode block size for THIS request's launch (the
    #: engine override the scheduler applies — EngineConfig.decode_k);
    #: None inherits the engine's configured value.  Part of the
    #: coalescer compatibility key: mixed-K requests must never share an
    #: engine call (the K path's chunk consumption differs per K).
    decode_k: Optional[int] = None
    #: which model should answer — read by the EnginePool router
    #: (serve/pool.py) to pick a compatible replica; inert on a
    #: single-engine Scheduler (its one engine IS the model).  None on
    #: a single-model pool resolves to that model.
    model: Optional[str] = None

    def validate(self) -> None:
        has_prompt = self.prompt is not None
        has_pair = self.prefix is not None or self.suffix is not None
        if has_prompt == has_pair:
            raise ValueError(
                "ScoreRequest takes exactly one of prompt= or "
                "prefix=+suffix=")
        if has_pair and (self.prefix is None or self.suffix is None):
            raise ValueError("prefix and suffix must be given together")
        if len(self.targets) != 2:
            raise ValueError(f"targets must be a (yes, no) pair, got "
                             f"{self.targets!r}")
        if self.decode_k is not None and self.decode_k < 1:
            raise ValueError(f"decode_k must be >= 1, got {self.decode_k}")


class ScoreFuture:
    """Thread-safe one-shot result slot for a submitted request.

    ``timing`` is the request's latency anatomy — set by the scheduler
    just before the result lands, so it is readable whenever ``result()``
    has returned: ``{"e2e_ms", "queue_wait_ms", "coalesce_ms",
    "serve_engine_ms", "respond_ms"}`` (serve/load.py semantics; the
    four phases sum to e2e).  It rides the FUTURE, not the result row,
    so the replay bit-parity contract never sees it.

    Resolution is AT-MOST-ONCE: the first ``_set_result`` /
    ``_set_exception`` wins and every later attempt is a silent no-op.
    Under the pool's failover and hedging paths (serve/supervisor.py) two
    legs of the same request can race to answer — first-wins is what makes
    "requests re-route to a sibling" safe without a cancellation protocol
    for the loser."""

    __slots__ = ("_event", "_lock", "_row", "_err", "timing")

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._row: Optional[Dict] = None
        self._err: Optional[BaseException] = None
        self.timing: Optional[Dict] = None

    # -- scheduler side --------------------------------------------------

    def _set_result(self, row: Dict) -> bool:
        """First resolution wins; returns False when already resolved."""
        with self._lock:
            if self._event.is_set():
                return False
            self._row = row
            self._event.set()
            return True

    def _set_exception(self, err: BaseException) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._err = err
            self._event.set()
            return True

    # -- caller side -----------------------------------------------------

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Dict:
        """The result-row dict; raises the request's typed error (or the
        engine error that failed its micro-batch) instead of returning.
        ``TimeoutError`` when the result is not ready within ``timeout``."""
        if not self._event.wait(timeout):
            raise TimeoutError("score request still pending")
        if self._err is not None:
            raise self._err
        assert self._row is not None
        return self._row

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        # graftlint: disable=G11 the in-tree callers (pool reap / supervisor orphan sweep) enter with the router lock held but only ever on done() futures and with timeout=0 — the event wait returns without blocking
        if not self._event.wait(timeout):
            raise TimeoutError("score request still pending")
        return self._err
