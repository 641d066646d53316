"""Device out-of-memory classification, the batch back-off ladder, the
transient-error retry and the preemption guard (a copy of
``runtime/faults.py``'s ``is_oom``/``oom_detail``/``next_batch_down``,
``TransientError``/``is_transient``/``default_transient_policy``/
``retry_transient`` and ``Preempted``/``PreemptionGuard``).

The engine retries a batch whose launch or consume ran out of device memory
at the next size down the ladder (:func:`next_batch_down`), and records the
step (``utils.telemetry.record_fault``).  :func:`is_oom` also knows PyTorch's
spellings: ``torch.OutOfMemoryError`` and a ``RuntimeError`` whose text says
"CUDA out of memory".  The sweep shell wraps its engine calls in
:func:`retry_transient` (connection resets and the like retry in place, OOM
and real errors propagate) and its chunk loop in :class:`PreemptionGuard`
(SIGTERM/SIGINT flush the checkpoint before the process exits).
"""

from __future__ import annotations

import dataclasses
import signal
import sys
import threading
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..utils.retry import RetryPolicy, retry_with_exponential_backoff
from ..utils.telemetry import record_fault


def is_oom(err: BaseException) -> bool:
    """Device out-of-memory: a ``torch.OutOfMemoryError``, an error whose
    text says "CUDA out of memory", or one of the status spellings
    'RESOURCE_EXHAUSTED' / 'ResourceExhausted' / 'Resource exhausted'."""
    if isinstance(err, torch.OutOfMemoryError):
        return True
    s = str(err).lower()
    if "cuda out of memory" in s:
        return True
    return "resourceexhausted" in s.replace("_", "").replace(" ", "")


def oom_detail(err: BaseException, limit: int = 160) -> str:
    """One-line truncated error text for OOM retry messages and the fault
    log, so a misclassified error leaves a trail."""
    text = " ".join(str(err).split())
    return text[:limit] + ("..." if len(text) > limit else "")


def next_batch_down(batch: int, ladder: Sequence[int] = (),
                    floor: int = 1) -> Optional[int]:
    """Next smaller batch size on the back-off ladder, or None at the floor.

    Walks ``ladder`` first (the largest entry strictly below ``batch``);
    below the ladder, or with none, the batch halves.  Never returns a value
    below ``floor`` (clamped to 1, so a zero floor steps to batch 1, never
    to an unlaunchable batch 0); None when ``batch`` is already at or below
    the floor, which tells the caller to re-raise."""
    floor = max(1, int(floor))
    if batch <= floor:
        return None
    for step in sorted(ladder, reverse=True):
        if step < batch:
            return max(floor, int(step))
    return max(floor, batch // 2)


class TransientError(RuntimeError):
    """Marker for injected or known-transient failures."""


#: Exception classes retried as transient.  OOM is excluded: it has its own
#: back-off path (the batch ladder), and retrying it at the same shape only
#: reproduces it.
TRANSIENT_ERROR_TYPES: Tuple[type, ...] = (
    TransientError, ConnectionError, TimeoutError, BrokenPipeError,
)

#: Substrings marking a transient failure when the class is generic.
_TRANSIENT_MARKERS = ("unavailable", "deadline exceeded", "connection reset",
                      "transient", "temporarily")


def is_transient(err: BaseException) -> bool:
    """Worth retrying in place: connection hiccups, resets, injected
    transients; never OOM (which steps the batch down instead) and never
    ordinary programming errors."""
    if is_oom(err):
        return False
    if isinstance(err, TRANSIENT_ERROR_TYPES):
        return True
    text = str(err).lower()
    return any(m in text for m in _TRANSIENT_MARKERS)


def default_transient_policy() -> RetryPolicy:
    """Local-engine transient policy: 3 quick retries."""
    return RetryPolicy(max_retries=3, initial_delay=2.0, max_delay=30.0,
                       retry_predicate=is_transient)


def retry_transient(fn: Callable, policy: Optional[RetryPolicy] = None,
                    label: str = "") -> Callable:
    """Wrap ``fn`` so transient errors retry per ``policy`` (default
    :func:`default_transient_policy`), recording a ``transient_retry`` fault
    event per retried error.  Non-transient errors propagate at once; a
    transient error that still propagates (the budget is spent) records a
    ``transient_exhausted`` event before it re-raises."""
    policy = policy or default_transient_policy()
    inner = policy.retry_predicate or is_transient
    name = label or getattr(fn, "__name__", "")

    def recording_predicate(err: BaseException) -> bool:
        if not inner(err):
            return False
        record_fault("transient_retry", label=name, error=oom_detail(err))
        return True

    policy = dataclasses.replace(policy, retry_predicate=recording_predicate)
    retrying = retry_with_exponential_backoff(policy)(fn)

    def run(*args, **kwargs):
        try:
            return retrying(*args, **kwargs)
        except Exception as err:
            if inner(err):
                record_fault("transient_exhausted", label=name,
                             retries=policy.max_retries,
                             error=oom_detail(err))
            raise

    return run


class Preempted(SystemExit):
    """Raised from the signal handler after checkpoint state is flushed; a
    ``SystemExit``, so an unguarded run exits with 128 + signum."""

    def __init__(self, signum: int):
        super().__init__(128 + int(signum))
        self.signum = int(signum)


class PreemptionGuard:
    """Flush checkpoint state on SIGTERM/SIGINT, then exit.

    Installed around a sweep's chunk loop, each registered flush runs once
    on the signal (a failing flush never blocks the next), a ``preempted``
    fault event is recorded, and :class:`Preempted` (SIGTERM) or
    ``KeyboardInterrupt`` (SIGINT) is raised in the main thread, so the
    sweep resumes losing at most the in-flight chunk.  Handlers are
    restored on exit.  Outside the main thread no handler can be installed
    and the guard does nothing."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, *flushes: Callable[[], None], label: str = ""):
        self.flushes = list(flushes)
        self.label = label
        self.triggered: Optional[int] = None
        self.active = False
        self._previous = {}

    def _handler(self, signum, frame):
        self.triggered = signum
        self.flush(reason=f"signal {signum}")
        record_fault("preempted", label=self.label, signum=int(signum))
        if signum == signal.SIGINT:
            raise KeyboardInterrupt
        raise Preempted(signum)

    def flush(self, reason: str = "") -> None:
        """Run every registered flush once, each guarded: a failing flush
        (a full disk) must not keep the rest from landing inside the grace
        window."""
        for fn in self.flushes:
            try:
                fn()
            except Exception as err:
                print(f"# preemption flush failed ({reason}): {err}",
                      file=sys.stderr)

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            return self
        try:
            for sig in self.SIGNALS:
                self._previous[sig] = signal.signal(sig, self._handler)
            self.active = True
        except (ValueError, OSError):
            for sig, prev in self._previous.items():
                signal.signal(sig, prev)
            self._previous.clear()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._previous.clear()
        self.active = False
