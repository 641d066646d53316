"""Live metrics export: registry, Prometheus text exposition, HTTP
endpoint, and the streaming JSONL metrics log.

Before this module the run-health surface was post-hoc only: telemetry
counters and sample rings (:mod:`..utils.telemetry`) become visible when
a bench record or a strict report serializes them at END of run.  A
serving process answering live traffic — or a multi-hour sweep someone
wants to watch from a dashboard — needs the same numbers continuously:

- :class:`MetricsRegistry` — the periodic sampler.  Each
  :meth:`~MetricsRegistry.sample` snapshots every telemetry counter
  (reported both raw and as the since-enable delta, the
  ``counters_since`` discipline every bench block already follows),
  every sample ring's percentiles (p50/p90/p99 + total/retained, so the
  ring-truncation semantics stay visible), and any explicitly set
  gauges, into bounded typed time-series.  Counters are Prometheus
  ``counter``\\ s (monotone), ring percentiles export as a ``summary``,
  explicit gauges as ``gauge``.
- :func:`prometheus_text` / :meth:`MetricsRegistry.prometheus_text` —
  the text exposition (format 0.0.4): sanitized metric names under the
  ``llm_interp_`` prefix, escaped label values, one ``# TYPE`` line per
  family, and NO series for rings that never recorded a sample (an
  empty ring must not fabricate a 0-quantile).
- :class:`MetricsServer` — a stdlib-only ``ThreadingHTTPServer`` on a
  daemon thread answering ``GET /metrics`` (the exposition) and
  ``GET /healthz`` (a JSON liveness document, extensible by the host —
  the serve scheduler reports queue depth and closed-ness).  Hosted by
  the ``serve`` CLI behind ``--metrics-port``.
- the JSONL metrics log (``enable_jsonl``) — sweep/bench modes have no
  resident server, so ``--metrics [PATH]`` streams one JSON object per
  sample instead; a crashed run keeps every line already flushed.
- :func:`heartbeat` — the sweep shells' ONE code path for progress:
  formats and logs the ``[heartbeat] done/total | rows/s | ETA`` line
  exactly as before, records the same numbers as registry gauges (and a
  JSONL sample when armed), and feeds the stall watchdog
  (:mod:`.flight`) — so sweep progress is observable without scraping
  stderr.

Measurement-only, like the rest of obs/: nothing here touches the
scoring path, and every export reads the telemetry layer's existing
thread-safe snapshots.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..utils import telemetry

#: points retained per time-series (newest win); bounds a week-long
#: server the same way the telemetry sample rings bound themselves.
DEFAULT_SERIES_CAP = 4096

#: every exported metric family lives under this prefix.
METRIC_PREFIX = "llm_interp_"

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")
_RING_PCTS = (50.0, 90.0, 99.0)
#: streaming-histogram percentiles: exact counts, no truncation, so the
#: p99.9 the bounded rings cannot keep is reportable here
_HIST_PCTS = (50.0, 90.0, 99.0, 99.9)


def sanitize_metric_name(name: str) -> str:
    """Prometheus metric-name charset: ``[a-zA-Z_:][a-zA-Z0-9_:]*``.
    Invalid characters become ``_``; a leading digit gains one."""
    name = _NAME_BAD_CHARS.sub("_", name)
    if not name or not _NAME_OK.match(name):
        name = "_" + name
    return name


def split_labeled_name(name: str):
    """``(base, labels_or_None)`` for the labeled-telemetry convention
    ``name|k=v,k2=v2`` (serve/scheduler.labeled_metric): the telemetry
    layer keys plain strings, so per-replica series ride the name — the
    exporter splits them back into ONE Prometheus family with label
    sets, which is how the EnginePool's ``serve_*`` counters and
    latency histograms read as ``{replica="r0",model="..."}`` series
    instead of N separate families."""
    if "|" not in name:
        return name, None
    base, _, rest = name.partition("|")
    labels = {}
    for part in rest.split(","):
        k, _, v = part.partition("=")
        if k:
            labels[k] = v
    return base, (labels or None)


def escape_label_value(value: str) -> str:
    """Label-value escaping per the exposition format: backslash, double
    quote, and newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _format_labels(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{sanitize_metric_name(k)}="{escape_label_value(v)}"'
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _format_value(value: float) -> str:
    if value != value:                      # NaN never reaches a scraper
        return "0"
    if float(value).is_integer() and abs(value) < 2 ** 53:
        return str(int(value))
    return repr(float(value))


class MetricsRegistry:
    """Typed time-series over the telemetry layer + explicit gauges.

    One registry per process (module singleton via :func:`get_registry`);
    tests may build their own.  All methods are thread-safe — the HTTP
    handler threads, the periodic sampler, and the sweep's heartbeat all
    touch one instance."""

    def __init__(self, series_cap: int = DEFAULT_SERIES_CAP):
        self._lock = threading.Lock()
        self._series_cap = max(1, int(series_cap))
        self._series: Dict[str, List[Tuple[float, float]]] = {}
        self._types: Dict[str, str] = {}       # series name -> counter|gauge
        self._gauges: Dict[Tuple[str, Tuple], Tuple[float, Dict]] = {}
        self._snap0 = telemetry.counters()     # since-enable baseline
        self._jsonl_path: Optional[str] = None
        self._jsonl_file = None
        self._sampler: Optional[threading.Thread] = None
        self._sampler_stop = threading.Event()
        self._t0 = time.time()

    # -- configuration ---------------------------------------------------

    def reset(self) -> None:
        """Drop every series/gauge and re-baseline the counter snapshot
        (tests / fresh sessions)."""
        self.disable_jsonl()
        with self._lock:
            self._series = {}
            self._types = {}
            self._gauges = {}
            self._snap0 = telemetry.counters()
            self._t0 = time.time()

    def enable_jsonl(self, path: str) -> None:
        """Stream one JSON object per :meth:`sample` to ``path`` (``w``
        mode: the log is one session's series, like the span log)."""
        with self._lock:
            if self._jsonl_file is not None:
                return
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            self._jsonl_path = path
            self._jsonl_file = open(path, "w", encoding="utf-8")

    def disable_jsonl(self) -> None:
        with self._lock:
            if self._jsonl_file is not None:
                self._jsonl_file.close()
                self._jsonl_file = None
                self._jsonl_path = None

    @property
    def jsonl_path(self) -> Optional[str]:
        return self._jsonl_path

    # -- recording -------------------------------------------------------

    def set_gauge(self, name: str, value: float,
                  labels: Optional[Dict[str, str]] = None) -> None:
        """Record an instantaneous value (progress, rate, ETA).  Each
        distinct (name, labels) pair is one series."""
        labels = dict(labels or {})
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._gauges[key] = (float(value), labels)
            self._record(f"{name}{_format_labels(labels)}", float(value),
                         "gauge")

    def _record(self, series: str, value: float, kind: str) -> None:
        # callers hold self._lock
        self._types[series] = kind
        points = self._series.setdefault(series, [])
        points.append((time.time(), float(value)))
        if len(points) > self._series_cap:
            del points[: len(points) - self._series_cap]

    def sample(self) -> Dict:
        """One sampler tick: snapshot counters (raw + since-enable delta
        via ``counters_since``) and ring percentiles into the series, and
        append the JSONL line when the stream is armed.  Returns the
        sampled document."""
        counters = telemetry.counters()
        delta = telemetry.counters_since(self._snap0)
        rings = {}
        for name, meta in telemetry.sample_ring_report().items():
            pct = telemetry.sample_percentiles(name, _RING_PCTS)
            rings[name] = {**meta, **pct}
        hists = {}
        for name, h in telemetry.hist_report().items():
            pct = telemetry.hist_percentiles(name, _HIST_PCTS)
            hists[name] = {"count": h["count"],
                           "sum": round(h["sum"], 3), **pct}
        doc = {
            "t": round(time.time(), 3),
            "uptime_s": round(time.time() - self._t0, 3),
            "counters": {k: v for k, v in sorted(counters.items())},
            "counters_delta": {k: v for k, v in sorted(delta.items())},
            "rings": rings,
            "hists": hists,
        }
        with self._lock:
            for name, value in counters.items():
                self._record(name, value, "counter")
            for name, meta in rings.items():
                for p in _RING_PCTS:
                    key = f"p{p:g}"
                    if key in meta:
                        self._record(f"{name}_{key}", meta[key], "gauge")
            gauges = {name + _format_labels(labels): value
                      for (name, _), (value, labels) in self._gauges.items()}
            doc["gauges"] = gauges
            f = self._jsonl_file
            if f is not None:
                f.write(json.dumps(doc) + "\n")
                f.flush()           # a killed run keeps every flushed line
        return doc

    # -- reading ---------------------------------------------------------

    def series(self, name: str) -> List[Tuple[float, float]]:
        with self._lock:
            return list(self._series.get(name, ()))

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def series_type(self, name: str) -> Optional[str]:
        with self._lock:
            return self._types.get(name)

    def prometheus_text(self) -> str:
        """The current state (fresh counter/ring snapshots + gauges) in
        Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        typed: set = set()

        def family(name: str, kind: str):
            """(metric, labels) with the TYPE line emitted once per base
            family — labeled series (the ``name|k=v`` convention) group
            under their base name instead of minting a family each."""
            base, labels = split_labeled_name(name)
            metric = METRIC_PREFIX + sanitize_metric_name(base)
            if metric not in typed:
                lines.append(f"# TYPE {metric} {kind}")
                typed.add(metric)
            return metric, labels

        for name, value in sorted(telemetry.counters().items()):
            metric, labels = family(name, "counter")
            lines.append(
                f"{metric}{_format_labels(labels)} {_format_value(value)}")
        # rings as summaries; sample_ring_report only lists rings with at
        # least one recorded sample, so an empty ring emits NO series
        for name, meta in sorted(telemetry.sample_ring_report().items()):
            pct = telemetry.sample_percentiles(name, _RING_PCTS)
            if not pct:
                continue
            metric, labels = family(name, "summary")
            for p in _RING_PCTS:
                key = f"p{p:g}"
                if key in pct:
                    qlabels = {**(labels or {}), "quantile": f"{p / 100.0:g}"}
                    lines.append(f"{metric}{_format_labels(qlabels)} "
                                 f"{_format_value(pct[key])}")
            lines.append(f"{metric}_count{_format_labels(labels)} "
                         f"{int(meta['total'])}")
            lines.append(f"{metric}_retained{_format_labels(labels)} "
                         f"{int(meta['retained'])}")
        # streaming histograms (telemetry.record_hist) as Prometheus
        # ``histogram`` families: cumulative ``_bucket{le=...}`` over the
        # exact log-bucket counts plus ``_sum``/``_count``.  hist_report
        # only lists histograms with >= 1 observation, so an empty one
        # emits NO series (the empty-ring discipline above)
        for name, h in sorted(telemetry.hist_report().items()):
            metric, labels = family(name, "histogram")
            cum = 0
            for le, n in h["buckets"]:
                cum += n
                blabels = {**(labels or {}), "le": f"{le:g}"}
                lines.append(f"{metric}_bucket{_format_labels(blabels)} "
                             f"{cum}")
            inf_labels = {**(labels or {}), "le": "+Inf"}
            lines.append(f"{metric}_bucket{_format_labels(inf_labels)} "
                         f"{int(h['count'])}")
            lines.append(f"{metric}_sum{_format_labels(labels)} "
                         f"{_format_value(h['sum'])}")
            lines.append(f"{metric}_count{_format_labels(labels)} "
                         f"{int(h['count'])}")
        with self._lock:
            # sort on (name, canonical label tuple) — two gauges sharing a
            # name but differing in labels must never compare their label
            # DICTS (TypeError), which is exactly the heartbeat shape: one
            # gauge name, one series per sweep label
            gauges = sorted(
                ((name, labels, value)
                 for (name, _), (value, labels) in self._gauges.items()),
                key=lambda g: (g[0], tuple(sorted(g[1].items()))))
        seen_type = set()
        for name, labels, value in gauges:
            metric = METRIC_PREFIX + sanitize_metric_name(name)
            if metric not in seen_type:
                lines.append(f"# TYPE {metric} gauge")
                seen_type.add(metric)
            lines.append(
                f"{metric}{_format_labels(labels)} {_format_value(value)}")
        return "\n".join(lines) + "\n"

    # -- periodic sampler ------------------------------------------------

    def start_sampler(self, interval_s: float = 5.0) -> None:
        """Sample every ``interval_s`` on a daemon thread (idempotent)."""
        if self._sampler is not None and self._sampler.is_alive():
            return
        self._sampler_stop.clear()

        def loop():
            while not self._sampler_stop.wait(interval_s):
                self.sample()

        self._sampler = threading.Thread(target=loop, name="obs-metrics",
                                         daemon=True)
        self._sampler.start()

    def stop_sampler(self) -> None:
        self._sampler_stop.set()
        if self._sampler is not None:
            self._sampler.join(timeout=2.0)
            self._sampler = None


# ---------------------------------------------------------------------------
# HTTP endpoint (stdlib only)
# ---------------------------------------------------------------------------

class MetricsServer:
    """``/metrics`` + ``/healthz`` over ``http.server`` on a daemon
    thread.  ``healthz_fn`` (optional) contributes extra keys to the
    health document — the serve scheduler reports queue depth and
    closed-ness through it.  ``port=0`` binds an ephemeral port (tests);
    read :attr:`port` after :meth:`start`.

    Binds loopback by default: the endpoint is unauthenticated, so
    exposing it beyond the host is an explicit operator decision
    (``host="0.0.0.0"``), never a default."""

    def __init__(self, registry: MetricsRegistry, port: int,
                 host: str = "127.0.0.1",
                 healthz_fn: Optional[Callable[[], Dict]] = None):
        self.registry = registry
        self.host = host
        self.port = int(port)
        self.healthz_fn = healthz_fn
        self._httpd = None
        self._thread: Optional[threading.Thread] = None
        self._t0 = time.time()

    def start(self) -> "MetricsServer":
        import http.server

        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):   # no per-scrape stderr spam
                pass

            def _send(self, code: int, content_type: str,
                      body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = server.registry.prometheus_text().encode("utf-8")
                    self._send(200, "text/plain; version=0.0.4; "
                                    "charset=utf-8", body)
                elif path == "/healthz":
                    doc = {"status": "ok",
                           "uptime_s": round(time.time() - server._t0, 3)}
                    if server.healthz_fn is not None:
                        try:
                            doc.update(server.healthz_fn())
                        except Exception as err:  # graftlint: disable=G05 liveness probe: a failing health contributor downgrades the document, it must never 500 the scrape loop
                            doc["status"] = "degraded"
                            doc["error"] = str(err)
                    body = json.dumps(doc).encode("utf-8")
                    self._send(200, "application/json", body)
                else:
                    self._send(404, "text/plain; charset=utf-8",
                               b"not found\n")

        self._httpd = http.server.ThreadingHTTPServer(
            (self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-metrics-http",
            daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Module singleton + the heartbeat code path
# ---------------------------------------------------------------------------

_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def prometheus_text() -> str:
    return _REGISTRY.prometheus_text()


def enable_jsonl(path: str) -> MetricsRegistry:
    _REGISTRY.enable_jsonl(path)
    return _REGISTRY


def heartbeat(label: str, done: int, total: int, elapsed_s: float,
              log: Optional[Callable[[str], None]] = None,
              unit: str = "rows", rate: Optional[float] = None,
              rate_unit: Optional[str] = None,
              eta_s: Optional[float] = None) -> str:
    """The sweep shells' single progress code path.

    Formats the ``[heartbeat]`` line (the perturbation shell's format,
    byte-identical; the instruct shell's line gains this
    labeled spelling), emits it through ``log`` (when given), records
    the same numbers as registry gauges — ``sweep_progress_rows``,
    ``sweep_progress_total``, ``sweep_rows_per_s``, ``sweep_eta_s``,
    each labeled by ``label`` — appends a JSONL metrics sample when the
    stream is armed, and beats the active stall watchdog
    (:mod:`.flight`).  Returns the formatted line.

    ``rate``/``rate_unit``/``eta_s`` override the ``done/elapsed``
    derivation when the progress unit and the rate unit differ (the
    instruct sweep counts MODELS but reports rows/s, so its ETA is
    caller-computed)."""
    if rate is None:
        rate = done / elapsed_s if elapsed_s > 0 else 0.0
    eta = (eta_s if eta_s is not None
           else ((total - done) / rate if rate > 0 else 0.0))
    line = (f"[heartbeat] {label}: {done}/{total} {unit} "
            f"| {rate:.2f} {rate_unit or unit}/s | ETA {eta:.0f}s")
    if log is not None:
        log(line)
    labels = {"label": label}
    _REGISTRY.set_gauge("sweep_progress_rows", done, labels)
    _REGISTRY.set_gauge("sweep_progress_total", total, labels)
    _REGISTRY.set_gauge("sweep_rows_per_s", round(rate, 3), labels)
    _REGISTRY.set_gauge("sweep_eta_s", round(eta, 1), labels)
    if _REGISTRY.jsonl_path is not None:
        _REGISTRY.sample()
    from . import flight

    flight.notify_heartbeat(label=label, done=done, total=total,
                            rate=round(rate, 3))
    return line
