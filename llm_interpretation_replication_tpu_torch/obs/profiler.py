"""Windowed ``torch.profiler`` capture + device-memory snapshots.

Host spans (:mod:`.tracer`) decompose wall-clock per phase; when a phase
itself needs explaining (which kernel inside the decode is slow), the
profiler's device timeline is the next tool down.  ``profile_window``
wraps one measured window — the CLI's ``--profile DIR`` captures the
whole command — with CPU activity, and CUDA activity where a card is
present, and writes a Chrome trace into DIR at exit, viewable in
Perfetto and parsed headlessly by
:func:`..utils.profiling.top_device_ops`.  Kernels launched through the
port's ``ctypes`` libraries appear there under their ``.cu`` symbols.

Capture is best-effort by design: a profiler that cannot start (or a
capture already in flight) logs one stderr line and the measured run
proceeds untraced — a run must never die on its own instrumentation.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Dict, Iterator, List, Optional

from .tracer import get_tracer

#: suffix of the Chrome traces ``profile_window`` writes
TRACE_SUFFIX = ".pt.trace.json"


@contextlib.contextmanager
def profile_window(log_dir: Optional[str], enabled: bool = True) -> Iterator[bool]:
    """Capture a ``torch.profiler`` trace into ``log_dir`` for the duration
    (``<host>.<pid>.<ms>.pt.trace.json``).

    Yields True when a capture actually started (False when disabled or
    the profiler was unavailable).  Start/stop failures degrade to a
    stderr note instead of failing the profiled run."""
    if not enabled or not log_dir:
        yield False
        return
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
    # graftlint: disable=G05 best-effort capture: a profiler that cannot start must not kill the measured run it was decorating
    except Exception as err:
        print(f"# obs: torch.profiler capture unavailable ({err}); "
              f"window runs unprofiled", file=sys.stderr)
        yield False
        return
    try:
        yield True
    finally:
        try:
            prof.stop()
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, (
                f"{os.uname().nodename}.{os.getpid()}."
                f"{int(time.time() * 1000)}{TRACE_SUFFIX}"))
            prof.export_chrome_trace(path)
            print(f"# obs: profiler capture written to {path}",
                  file=sys.stderr)
        # graftlint: disable=G05 best-effort capture teardown: a stop failure loses the capture, never the measured result
        except Exception as err:
            print(f"# obs: torch.profiler stop failed ({err})",
                  file=sys.stderr)


def device_memory_snapshot(tag: str = "") -> List[Dict]:
    """Per-device memory stats from ``torch.cuda.memory_stats`` (the
    caching allocator's ``allocated_bytes.all.current`` as
    ``bytes_in_use`` and ``.peak`` as ``peak_bytes_in_use``) and
    ``torch.cuda.mem_get_info`` (the card's total as ``bytes_limit``),
    recorded as a zero-duration ``device_memory`` span when tracing is on.
    Returns the snapshot list ([] without CUDA)."""
    out: List[Dict] = []
    try:
        import torch

        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                ms = torch.cuda.memory_stats(i)
                out.append({
                    "device": f"cuda:{i}",
                    "bytes_in_use": int(ms.get("allocated_bytes.all.current",
                                               0)),
                    "bytes_limit": int(torch.cuda.mem_get_info(i)[1]),
                    "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak",
                                                    0)),
                })
    # graftlint: disable=G05 telemetry probe: a backend without memory stats must never fail the run being observed
    except Exception:
        return out
    tracer = get_tracer()
    if tracer.enabled and out:
        now = time.monotonic()
        tracer.add_span("device_memory", now, now, tag=tag,
                        devices=out,
                        bytes_in_use=sum(d["bytes_in_use"] for d in out))
    return out
