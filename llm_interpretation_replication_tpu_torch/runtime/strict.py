"""Runtime strict mode: host syncs in the engine's launch paths, caught at
run time (the JAX package's ``runtime/strict.py`` on PyTorch's sync debug
mode).

- **Sync guard** — :func:`scoring_guard` sets
  ``torch.cuda.set_sync_debug_mode("error")`` around the engine's scoring
  pipeline (``runtime/engine._run_pipelined``), so a CUDA operation that
  makes the host wait for the device in a launch path raises instead of
  silently draining the pipeline.  The pipeline's ``consume`` callbacks —
  the sanctioned fetch points — run inside :func:`sanctioned_fetch`, which
  sets the mode to 0 locally.  Both restore the mode they found on exit,
  nested or not.  A rejected sync increments the ``blocked_transfers``
  telemetry counter (and records a ``blocked_transfer`` fault event)
  before the error propagates, so a clean operating point is provable as
  ``blocked_transfers == 0``.
- **Build sentry** — eager PyTorch compiles nothing per shape, so the JAX
  package's log-compiles sentry has no counterpart.  What the port does
  compile is its CUDA sources: :class:`RecompileSentry` counts each
  ``nvcc`` build ``ops/_build.py`` starts while strict mode is armed into
  the same ``recompile_events`` counter.  A warm repeat must hold it flat.

Each thread's mode is its own, as the JAX package's transfer-guard
contexts are: :func:`sync_debug_mode` returns the calling thread's
innermost region's mode, and a region restores only its own thread's.
PyTorch's sync debug mode, though, is one setting for the whole process,
so the card's mode is derived from a registry of the threads inside a
region: "error" while some thread's innermost region is a guard and no
thread's is a sanctioned fetch, else the mode found before the first
region (restored when the last region exits, in any interleaving).  The
departure from the reference: on the card a guard is off while another
thread sits in a sanctioned fetch (a sync then passes where JAX would
raise), and a thread outside any region is guarded while another holds a
guard.  A sanctioned fetch never raises for another thread's guard.
Without CUDA (the CPU runs) only the per-thread modes exist, so the
nesting behaves the same and nothing is guarded: CPU tensors never make
the host wait.

Enablement is env-gated — ``LLM_INTERP_STRICT=1`` (0/off/empty disables)
— or explicit via :func:`activate`; the CLI's ``--strict`` routes here.
When inactive every context manager in this module is a no-op, so the
engine integration costs nothing in ordinary runs.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, Iterator, List, Optional

import torch

from ..utils.telemetry import (
    counter,
    record_counter,
    record_fault,
    sample_ring_report,
)

STRICT_ENV = "LLM_INTERP_STRICT"

#: telemetry counter names (documented in utils/telemetry.py)
RECOMPILE_COUNTER = "recompile_events"
BLOCKED_COUNTER = "blocked_transfers"

#: the mode the scoring guard arms (``torch.cuda.set_sync_debug_mode``)
GUARD_MODE = "error"
#: what PyTorch raises with when a synchronizing CUDA operation runs under
#: mode "error" (``c10/cuda/CUDAFunctions.cpp``)
SYNC_ERROR_TEXT = "called a synchronizing CUDA operation"

_MODES = {"default": 0, "warn": 1, "error": 2}

_ACTIVE = False
_SENTRY: Optional["RecompileSentry"] = None

_LOCAL = threading.local()      # .modes: this thread's stack of region modes
_LOCK = threading.Lock()
_REGIONS: Dict[int, int] = {}   # thread ident -> its innermost region's mode
_BASE: Optional[int] = None     # the card's mode before the first region


def env_requests_strict() -> bool:
    val = os.environ.get(STRICT_ENV)
    if val is None:
        return False
    return val.strip().lower() not in ("", "0", "off", "false", "no")


def strict_enabled() -> bool:
    """Is strict mode currently armed (activate() or the env gate)?"""
    return _ACTIVE


def _stack() -> List[int]:
    modes = getattr(_LOCAL, "modes", None)
    if modes is None:
        modes = _LOCAL.modes = []
    return modes


def _device_mode() -> int:
    if torch.cuda.is_available():
        return int(torch.cuda.get_sync_debug_mode())
    return 0


def sync_debug_mode() -> int:
    """The calling thread's sync debug mode: 0 off, 1 warn, 2 error (its
    innermost region's, else the mode found outside every region)."""
    modes = _stack()
    if modes:
        return modes[-1]
    base = _BASE
    return _device_mode() if base is None else base


def _apply_locked() -> None:
    """Set the card's mode from the registry (caller holds ``_LOCK``)."""
    if not torch.cuda.is_available():
        return
    inner = set(_REGIONS.values())
    guarded = _MODES[GUARD_MODE] in inner and 0 not in inner
    torch.cuda.set_sync_debug_mode(_MODES[GUARD_MODE] if guarded else _BASE)


@contextlib.contextmanager
def _mode(mode) -> Iterator[None]:
    global _BASE
    mode = _MODES.get(mode, mode)
    modes = _stack()
    tid = threading.get_ident()
    with _LOCK:
        if not _REGIONS:
            _BASE = _device_mode()
        modes.append(mode)
        _REGIONS[tid] = mode
        _apply_locked()
    try:
        yield
    finally:
        with _LOCK:
            modes.pop()
            if modes:
                _REGIONS[tid] = modes[-1]
            else:
                del _REGIONS[tid]
            _apply_locked()
            if not _REGIONS:
                _BASE = None


class RecompileSentry:
    """Counts the ``nvcc`` builds ``ops/_build.py`` starts while installed.

    Each build feeds the ``recompile_events`` telemetry counter and keeps
    its source name (bounded ring), so a build on a warm path is
    attributable by name, not just by count."""

    KEEP = 200

    def __init__(self):
        self.programs: List[str] = []

    def __call__(self, name: str) -> None:
        record_counter(RECOMPILE_COUNTER)
        self.programs.append(name)
        if len(self.programs) > self.KEEP:
            del self.programs[: len(self.programs) - self.KEEP]

    def install(self) -> None:
        from ..ops import _build

        _build.add_build_listener(self)

    def uninstall(self) -> None:
        from ..ops import _build

        _build.remove_build_listener(self)


def activate(sentry: bool = True) -> None:
    """Arm strict mode process-wide (idempotent).  ``sentry=False`` arms
    only the sync guards."""
    global _ACTIVE, _SENTRY
    _ACTIVE = True
    # a later activate(sentry=True) upgrades an earlier guards-only
    # activation — idempotency must not freeze recompile_events at 0
    if sentry and _SENTRY is None:
        s = RecompileSentry()
        s.install()
        _SENTRY = s


def deactivate() -> None:
    global _ACTIVE, _SENTRY
    _ACTIVE = False
    if _SENTRY is not None:
        _SENTRY.uninstall()
        _SENTRY = None


def activate_from_env() -> bool:
    """Arm strict mode iff ``LLM_INTERP_STRICT`` requests it; returns the
    resulting state.  The CLI calls this once at startup."""
    if env_requests_strict():
        activate()
    return _ACTIVE


def sentry_programs() -> List[str]:
    """Names of the sources the sentry saw built (newest last)."""
    return list(_SENTRY.programs) if _SENTRY is not None else []


def _is_transfer_guard_error(err: BaseException) -> bool:
    return isinstance(err, RuntimeError) and SYNC_ERROR_TEXT in str(err)


@contextlib.contextmanager
def _counting(label: str) -> Iterator[None]:
    """Count guard trips into ``blocked_transfers`` (+ a fault event for
    the audit trail) before propagating them; an error counted by an
    inner guard is not counted again."""
    try:
        yield
    except Exception as err:
        if (_is_transfer_guard_error(err)
                and not getattr(err, "_strict_counted", False)):
            err._strict_counted = True
            record_counter(BLOCKED_COUNTER)
            record_fault("blocked_transfer", label=label,
                         error=" ".join(str(err).split())[:160])
        raise


@contextlib.contextmanager
def scoring_guard(label: str = "") -> Iterator[None]:
    """Raise on any synchronizing CUDA operation for the duration — the
    engine wraps its scoring pipeline in this, so only code inside
    :func:`sanctioned_fetch` may make the host wait for the device.  No-op
    unless strict mode is active."""
    if not _ACTIVE:
        yield
        return
    with _counting(label or "scoring_guard"):
        with _mode(GUARD_MODE):
            yield


@contextlib.contextmanager
def sanctioned_fetch() -> Iterator[None]:
    """Allow syncs inside a :func:`scoring_guard` — the pipeline's
    ``consume`` callbacks are THE sanctioned fetch points.  No-op unless
    strict mode is active."""
    if not _ACTIVE:
        yield
        return
    with _mode("default"):
        yield


@contextlib.contextmanager
def device_region(label: str = "") -> Iterator[None]:
    """The strictest probe the card offers, for code that must be sync-free
    end to end (warmed inner loops, tests of the guard machinery).  The
    sync debug mode already covers both directions — a blocking
    host-to-device copy of pageable memory waits for its stream and trips
    it — so this is :func:`scoring_guard` under its own label."""
    if not _ACTIVE:
        yield
        return
    with _counting(label or "device_region"):
        with _mode(GUARD_MODE):
            yield


def strict_report() -> Dict:
    """Snapshot for an operator audit: ``enabled``, ``recompile_events``,
    ``blocked_transfers`` and, when any sample ring recorded, ``samples``
    (``{ring: {total, retained, cap}}`` — a ring whose ``total`` exceeds
    ``retained`` was truncated, so a percentile over it is a tail
    statistic)."""
    report = {
        "enabled": _ACTIVE,
        RECOMPILE_COUNTER: int(counter(RECOMPILE_COUNTER)),
        BLOCKED_COUNTER: int(counter(BLOCKED_COUNTER)),
    }
    samples = sample_ring_report()
    if samples:
        report["samples"] = samples
    return report
