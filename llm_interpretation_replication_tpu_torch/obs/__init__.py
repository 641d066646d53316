"""Observability: span tracing, phase attribution, and profiler hooks (a
copy of the JAX package's ``obs/`` with its device touch points on
``torch.cuda``).

Three cooperating layers, all measurement-only (no row changes):

- :mod:`.tracer` — a thread-safe nested span tracer on monotonic clocks.
  The engine hot path (host tokenize/prefetch, prefill — monolithic and
  chunked — ``extend_prefill``, decode chunks, pooled decode, host
  fetches) and the sweep shells open spans tagged by phase, leg, length
  bucket, and batch.  Spans export as Chrome-trace/Perfetto JSON and
  stream to a JSONL span log; per-phase SELF-time totals (nested phase
  spans never double-count) make the ``phases`` block.
- :mod:`.profiler` — a windowed ``torch.profiler`` capture (CPU and CUDA
  activity; ``--profile DIR`` on the CLI) written as a Chrome trace, plus
  device-memory snapshots, for when host spans are not enough and the
  kernel timeline is needed (``utils.profiling.top_device_ops`` reads it).
- :mod:`.report` — the ``obs report`` CLI over saved traces and the
  table/JSON renderers.

The run-health layer sits next to the tracer (measurement-only too):

- :mod:`.metrics` — metrics registry + Prometheus text exposition +
  stdlib ``/metrics``+``/healthz`` HTTP endpoint + streaming JSONL
  metrics log (``--metrics``), and the sweep shells' single
  :func:`~.metrics.heartbeat` code path (log line AND gauges from one
  place).
- :mod:`.flight` — flight recorder (bounded recent-activity ring dumped
  as a ``flightrec-*.json`` triage artifact on OOM-ladder engagement,
  transient-retry exhaustion, preemption, or watchdog trip) and the
  stall watchdog (warn + dump when a sweep stops progressing; never
  kills).
- :mod:`.benchdiff` — the ``obs bench-diff`` trajectory analyzer over
  ``BENCH_r*.json`` records (regression table with thresholds).

Strict-mode contract: tracing performs NO host sync of its own.  The
opt-in ``sync`` at span close (``enable(sync=True)``) synchronizes the
CUDA stream inside the strict layer's sanctioned-fetch scope, so a traced
run under ``LLM_INTERP_STRICT=1`` stays ``blocked_transfers == 0``.
"""

from .tracer import (
    SpanTracer,
    add_span,
    disable,
    enable,
    enabled,
    export_chrome,
    get_tracer,
    phase_snapshot,
    phase_totals,
    phase_totals_since,
    span,
)

__all__ = [
    "SpanTracer",
    "add_span",
    "disable",
    "enable",
    "enabled",
    "export_chrome",
    "get_tracer",
    "phase_snapshot",
    "phase_totals",
    "phase_totals_since",
    "span",
]
