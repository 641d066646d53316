"""Tracing / profiling helpers (a copy of the JAX package's
``utils/profiling.py`` on ``torch.profiler``).

``trace`` captures a ``torch.profiler`` window as a Chrome trace,
``annotate`` names a region inside it, ``top_device_ops`` sums a saved
capture's device time by kernel, and ``ThroughputMeter`` tracks
prompts/sec and tokens/sec/chip for sweeps.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Capture a ``torch.profiler`` trace into ``log_dir`` (CPU activity,
    and CUDA where a card is present), written as a Chrome trace at exit
    (``obs.profiler.profile_window``, which degrades to an unprofiled run
    when the profiler cannot start)."""
    from ..obs.profiler import profile_window

    with profile_window(log_dir, enabled=enabled):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a trace (shows up on the timeline)."""
    import torch

    with torch.profiler.record_function(name):
        yield


def _newest_trace(trace_dir: str) -> str:
    import glob
    import os

    paths = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True),
        key=os.path.getmtime,
    )
    if not paths:
        raise FileNotFoundError(f"no Chrome-trace *.json under {trace_dir}")
    return paths[-1]


def device_op_events(trace_dir: str) -> Dict[str, Tuple[int, float]]:
    """``{name: (events, total_ms)}`` over the newest Chrome-trace JSON
    under ``trace_dir`` (the ``profile_window`` capture): the CUDA kernel
    events (``cat == "kernel"``), or the CPU-op events (``cat ==
    "cpu_op"``) when the trace holds no kernel."""
    import json
    from collections import defaultdict

    with open(_newest_trace(trace_dir), encoding="utf-8") as f:
        events = json.load(f).get("traceEvents", [])
    for cat in ("kernel", "cpu_op"):
        out: Dict[str, list] = defaultdict(lambda: [0, 0.0])
        for ev in events:
            if ev.get("ph") == "X" and ev.get("cat") == cat:
                entry = out[ev.get("name", "?")]
                entry[0] += 1
                entry[1] += float(ev.get("dur", 0.0)) / 1e3   # us -> ms
        if out:
            return {name: (n, ms) for name, (n, ms) in out.items()}
    return {}


def top_device_ops(trace_dir: str, top_n: int = 25) -> List[Tuple[str, float]]:
    """Per-op device-time totals out of a :func:`trace` capture — the
    headless answer to a trace viewer's kernel table.

    Parses the newest Chrome-trace JSON under ``trace_dir`` and sums the
    durations of its kernel events by name (its CPU-op events when the
    trace holds no CUDA activity, as on the CPU).  Returns
    ``[(name, total_ms)]`` sorted descending."""
    totals = device_op_events(trace_dir)
    return sorted(((name, ms) for name, (_, ms) in totals.items()),
                  key=lambda kv: -kv[1])[:top_n]


class ThroughputMeter:
    def __init__(self, n_chips: int = 1, clock=time.perf_counter):
        self.n_chips = max(n_chips, 1)
        self._clock = clock
        self.reset()

    def reset(self):
        self._start = self._clock()
        self.prompts = 0
        self.tokens = 0

    def add(self, prompts: int, tokens: int = 0):
        self.prompts += prompts
        self.tokens += tokens

    def snapshot(self) -> dict:
        elapsed = max(self._clock() - self._start, 1e-9)
        return {
            "elapsed_sec": round(elapsed, 3),
            "prompts": self.prompts,
            "prompts_per_sec": round(self.prompts / elapsed, 4),
            "prompts_per_sec_per_chip": round(self.prompts / elapsed / self.n_chips, 4),
            "tokens_per_sec": round(self.tokens / elapsed, 2),
            "tokens_per_sec_per_chip": round(self.tokens / elapsed / self.n_chips, 2),
        }
