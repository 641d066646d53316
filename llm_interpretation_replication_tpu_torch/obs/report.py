"""Phase-attribution reporting: the ``phases`` block, the stderr table,
and the ``obs report`` CLI over saved traces.

The live path (bench): :func:`phases_block` turns the tracer's per-phase
self-time totals into the JSON block a bench record carries, and
:func:`format_phase_table` renders the same numbers as the stderr table.
The offline path (``python -m llm_interpretation_replication_tpu_torch
obs report --trace FILE``): :func:`load_spans` reads either export format —
the JSONL span log or the Chrome-trace JSON — re-aggregates per
phase/leg, and prints the table, so a saved trace from any past run
stays explainable without re-running it.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence


def phases_block(totals_by_leg: Dict[str, Dict[str, float]],
                 wall_s: Optional[float] = None,
                 rows: Optional[int] = None) -> Dict:
    """The bench-record ``phases`` block from per-(phase, leg) self-time
    totals (:meth:`..obs.tracer.SpanTracer.phase_totals` with
    ``by_leg=True``, or a :func:`load_spans` re-aggregation).

    ``wall_s`` is the measured wall-clock the totals should decompose
    (the sum of a bench's timed repeats): ``coverage`` = instrumented
    phase seconds / wall seconds — the acceptance bar is >= 0.9, i.e.
    at most 10% of the measured time is unattributed glue.  Phases on
    background threads (host tokenize overlap) are the honest reason
    coverage can exceed 1.0.  ``rows`` adds per-row milliseconds."""
    phases = {}
    total = 0.0
    for phase in sorted(totals_by_leg):
        legs = totals_by_leg[phase]
        phase_s = sum(legs.values())
        total += phase_s
        entry = {"seconds": round(phase_s, 3)}
        named = {leg: round(s, 3) for leg, s in sorted(legs.items()) if leg}
        if named:
            entry["legs"] = named
        if rows:
            entry["ms_per_row"] = round(phase_s / rows * 1e3, 3)
        phases[phase] = entry
    block: Dict = {"per_phase": phases, "total_s": round(total, 3)}
    if wall_s:
        block["wall_s"] = round(wall_s, 3)
        block["coverage"] = round(total / wall_s, 3)
    if rows:
        block["rows"] = int(rows)
    return block


def format_phase_table(block: Dict, title: str = "phase attribution") -> str:
    """Render a ``phases`` block as an aligned stderr table."""
    per_phase = block.get("per_phase", {})
    total = block.get("total_s", 0.0) or sum(
        e["seconds"] for e in per_phase.values())
    rows = []
    for phase, entry in sorted(per_phase.items(),
                               key=lambda kv: -kv[1]["seconds"]):
        share = entry["seconds"] / total if total else 0.0
        legs = entry.get("legs")
        leg_txt = (" (" + ", ".join(f"{k} {v:.2f}s"
                                    for k, v in legs.items()) + ")"
                   if legs else "")
        per_row = (f" {entry['ms_per_row']:8.2f} ms/row"
                   if "ms_per_row" in entry else "")
        rows.append(f"  {phase:<16} {entry['seconds']:9.2f}s "
                    f"{share * 100:5.1f}%{per_row}{leg_txt}")
    lines = [f"# {title}:"]
    lines.extend(rows or ["  (no phase spans recorded)"])
    tail = f"  {'total':<16} {total:9.2f}s"
    if block.get("wall_s"):
        tail += (f"  of {block['wall_s']:.2f}s wall "
                 f"({block.get('coverage', 0) * 100:.1f}% attributed)")
    lines.append(tail)
    return "\n".join(lines)


def format_serve_load_table(block: Dict) -> str:
    """The per-phase latency table from a bench record's ``serve_load``
    block: one section per offered rate — end-to-end
    p50/p90/p99/p99.9 plus each phase's (queue_wait / coalesce /
    serve_engine / respond) percentiles from the exact-count
    histograms, achieved-vs-offered, and the sweep's saturation/knee
    summary."""
    pcts = ("p50", "p90", "p99", "p99.9")
    lines = [f"# serve-load latency anatomy ({block.get('mode', '?')}, "
             f"seed {block.get('seed')}, {block.get('duration_s')}s per "
             f"rate):"]
    for point in block.get("rates", ()) or ():
        lines.append(
            f"  offered {point.get('offered_rate'):g} rows/s -> achieved "
            f"{point.get('achieved_rows_per_s')} "
            f"({point.get('completed')}/{point.get('requests')} ok, "
            f"{point.get('shed', 0)} shed, queue depth max "
            f"{(point.get('queue_depth') or {}).get('max')})")
        header = "    " + "phase".ljust(14) + "".join(
            f"{p:>10}" for p in pcts)
        lines.append(header)
        rows = [("e2e", point.get("latency_ms", {}))]
        rows += [(name, (point.get("phases_ms") or {}).get(name, {}))
                 for name in ("queue_wait", "coalesce", "serve_engine",
                              "respond")]
        for name, vals in rows:
            lines.append("    " + name.ljust(14) + "".join(
                f"{vals[p]:>10.2f}" if p in vals else f"{'-':>10}"
                for p in pcts))
    if block.get("knee_floor_saturated"):
        knee_txt = "unknown (every swept rate saturated)"
    elif block.get("knee_beyond_sweep"):
        knee_txt = "beyond sweep"
    else:
        knee_txt = f"at {block.get('knee_offered_rate')} offered"
    tail = (f"  saturation {block.get('saturation_rows_per_s')} rows/s, "
            f"knee {knee_txt}")
    if block.get("parity_ok") is not None:
        tail += (", parity OK" if block["parity_ok"]
                 else ", PARITY FAILED")
    lines.append(tail)
    return "\n".join(lines)


def load_spans(path: str) -> List[Dict]:
    """Read spans back from either export format.

    JSONL span log: one span object per line.  Chrome-trace JSON: the
    ``traceEvents`` "X" events map back to spans (``cat`` is the phase,
    ``args.leg``/``args.self_us`` restore the leg and self time)."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    try:
        # one whole-file JSON document == the Chrome-trace export; a
        # JSONL span log has one object PER LINE, so the whole-file parse
        # raises on its second line
        doc = json.loads(text)
    except ValueError:
        doc = None
    if isinstance(doc, dict) and "traceEvents" in doc:
        spans = []
        for ev in doc["traceEvents"]:
            if ev.get("ph") != "X":
                continue
            args = ev.get("args", {})
            phase = ev.get("cat")
            spans.append({
                "name": ev.get("name", ""),
                "phase": None if phase in (None, "span") else phase,
                "leg": args.get("leg"),
                "trace_id": args.get("trace_id"),
                "dur": ev.get("dur", 0.0) / 1e6,
                "self": args.get("self_us", ev.get("dur", 0.0)) / 1e6,
                "args": args,
            })
        return spans
    spans = []
    dropped = 0
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            spans.append(json.loads(line))
        except ValueError:
            # a hard-killed run can tear the trailing line mid-write
            # (the tracer flushes per span, but a kill can still land
            # inside one write) — the report over the surviving spans is
            # exactly what the crashed-run case needs
            dropped += 1
    if dropped:
        print(f"# obs report: skipped {dropped} malformed span line(s) "
              f"(torn tail of a killed run?)", file=sys.stderr)
    return spans


def aggregate_spans(spans: Sequence[Dict]) -> Dict[str, Dict[str, float]]:
    """Per-(phase, leg) SELF-time totals from loaded spans — the same
    shape the live tracer's ``phase_totals(by_leg=True)`` returns."""
    out: Dict[str, Dict[str, float]] = {}
    for s in spans:
        phase = s.get("phase")
        if not phase:
            continue
        leg = s.get("leg") or ""
        self_s = s.get("self")
        if self_s is None:
            self_s = s.get("dur", 0.0)
        by_leg = out.setdefault(phase, {})
        by_leg[leg] = by_leg.get(leg, 0.0) + float(self_s)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``obs`` CLI body (routed from __main__ like ``lint``): ``obs
    report`` aggregates a saved span trace; ``obs bench-diff`` runs the
    bench-trajectory regression analyzer (:mod:`.benchdiff`)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["bench-diff"]:
        # dispatched before this parser: bench-diff has its own argument
        # surface (positional records + thresholds)
        from .benchdiff import main as benchdiff_main

        return benchdiff_main(argv[1:])
    parser = argparse.ArgumentParser(
        prog="llm_interpretation_replication_tpu_torch obs",
        description="observability reports: 'report' aggregates a saved "
                    "span trace (JSONL span log or Chrome-trace/Perfetto "
                    "JSON) per phase/leg; 'bench-diff' aligns BENCH_r*."
                    "json records into a regression table")
    parser.add_argument("action", choices=["report", "bench-diff"],
                        help="'report': aggregate a saved trace per "
                             "phase/leg and print the table; "
                             "'bench-diff': compare bench records "
                             "(handled by obs/benchdiff.py)")
    parser.add_argument("--trace", default=None, metavar="PATH",
                        help="saved trace: the --trace JSONL span log or "
                             "the exported Chrome-trace JSON")
    parser.add_argument("--serve-load", default=None, metavar="BENCH.json",
                        help="render the per-phase latency table from a "
                             "bench record's serve_load block ("
                             "per-rate e2e + queue_wait/coalesce/"
                             "serve_engine/respond percentiles) instead "
                             "of a span trace")
    parser.add_argument("--wall-s", type=float, default=None, metavar="S",
                        help="measured wall-clock to compute coverage "
                             "against (e.g. the bench repeat time)")
    parser.add_argument("--rows", type=int, default=None, metavar="N",
                        help="row count for per-row milliseconds")
    parser.add_argument("--format", choices=["table", "json"],
                        default="table")
    args = parser.parse_args(argv)
    if args.serve_load:
        from .benchdiff import load_bench_record

        try:
            rec = load_bench_record(args.serve_load)
        except (OSError, ValueError) as err:
            print(f"obs report: cannot read {args.serve_load}: {err}",
                  file=sys.stderr)
            return 2
        block = rec.get("serve_load")
        if not isinstance(block, dict):
            print(f"obs report: {args.serve_load} carries no serve_load "
                  f"block (bench.py --serve-load produces one)",
                  file=sys.stderr)
            return 2
        if args.format == "json":
            print(json.dumps(block, indent=2))
        else:
            print(format_serve_load_table(block))
        return 0
    if not args.trace:
        parser.error("one of --trace or --serve-load is required")

    try:
        spans = load_spans(args.trace)
    except (OSError, ValueError) as err:
        print(f"obs report: cannot read {args.trace}: {err}",
              file=sys.stderr)
        return 2
    block = phases_block(aggregate_spans(spans), wall_s=args.wall_s,
                         rows=args.rows)
    if args.format == "json":
        print(json.dumps(block, indent=2))
    else:
        print(format_phase_table(
            block, title=f"phase attribution ({len(spans)} spans, "
                         f"{args.trace})"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
