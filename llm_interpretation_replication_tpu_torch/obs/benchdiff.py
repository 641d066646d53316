"""``obs bench-diff``: the bench-trajectory regression analyzer.

The repo's perf history lives in its ``BENCH_r*.json`` records
(r01 38.15 → r05 120.15 p/s), but every round the trajectory was
compared BY HAND and transcribed into ROADMAP prose.  This subcommand
makes the comparison a checked artifact: read two or more records, align
their headline, secondary metrics, phase decomposition, and operating-
context counters across rounds, and print a regression table — exit 1
when any throughput metric fell by more than the threshold, so a CI step
(or the next round's author) catches a regression the moment the record
lands instead of five rounds later.

Record shapes accepted, newest-field-tolerant:

- the run wrapper ``{"n", "cmd", "rc", "tail", "parsed": {...}}`` —
  the checked-in ``BENCH_r*.json`` files;
- a bare bench record (the one JSON line ``bench.py`` prints):
  ``{"metric", "value", "unit", "secondary": [...], "phases": {...},
  "context": {...}}``.

Metric alignment: the headline rows align positionally ("headline" key);
secondary rows align by a STABLE KEY derived from the metric description
(workload class + prompt-token length + batch-independent tags), because
the free-text metric strings legitimately drift round over round (batch
sizes, hit rates).  Rows present in only one record report as ``new`` /
``gone`` instead of silently vanishing from the table.

Regression semantics: throughput rows (prompts/sec, rows/sec — higher
is better) regress on a drop beyond ``--threshold`` percent; the
serve-load latency rows (``ms``, aligned per offered rate
from the record's ``serve_load`` block) regress on GROWTH beyond it;
phase rows compare ``ms_per_row`` (lower is better) when both records
carry a ``phases`` block.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Dict, List, Optional, Sequence, Tuple

#: units where larger values are better (everything bench records today).
_HIGHER_IS_BETTER_UNITS = ("prompts/sec", "rows/sec")

#: units where SMALLER values are better — the serve-load latency rows
#: a p99 that grew past the threshold is the regression.
_LOWER_IS_BETTER_UNITS = ("ms", "idle-frac")

#: units where ANY non-zero value is a regression, no percentage
#: threshold: the self-healing recovery block's ``requests_lost`` — one
#: lost request means the always-answered contract broke, and "only 3%
#: worse than last round's zero" is not a sentence that parses.
_HARD_ZERO_UNITS = ("lost-requests",)

#: The bench-record block contract :
#: every top-level block ``bench.py`` emits must be classified in exactly
#: one of these tuples, and every ALIGNED/CONTEXT entry must actually be
#: read by this module — so a new bench block cannot land without
#: teaching the diff what it means, and a block this module claims to
#: align cannot silently stop being flattened.
#:
#: blocks :func:`flatten_metrics` aligns into verdict/informational rows:
ALIGNED_BLOCKS = ("secondary", "brackets", "packed", "k_decode",
                  "occupancy", "serve_load", "serve_load_pool",
                  "recovery")
#: blocks :func:`diff_records` reads as cross-round context tables:
CONTEXT_BLOCKS = ("context", "phases")
#: blocks deliberately NOT aligned (free-form diagnostics whose shape is
#: owned by their producer; listed so the classification is a conscious
#: decision, not an omission):
INFORMATIONAL_BLOCKS = ("strict", "plan_search", "packed_drift", "serve",
                        "repeats")


def load_bench_record(path: str) -> Dict:
    """One record, unwrapped from the run wrapper when present, with a
    ``label`` derived from the filename (``BENCH_r04.json`` → ``r04``)."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    rec = doc.get("parsed") if isinstance(doc.get("parsed"), dict) else doc
    if not isinstance(rec, dict) or "value" not in rec:
        raise ValueError(f"{path}: not a bench record (no 'value' field)")
    stem = os.path.splitext(os.path.basename(path))[0]
    m = re.search(r"(r\d+)$", stem)
    rec = dict(rec)
    rec["label"] = m.group(1) if m else stem
    return rec


def metric_key(metric: str, unit: str) -> str:
    """Stable cross-round identity for a metric row.

    The free-text descriptions drift (batch sizes, measured hit rates,
    attn impl), so the key keeps only what identifies the WORKLOAD:
    the mode class, the prompt-token length when named, and the unit —
    plus the decode bracket and packing factor: an
    EOS-typical bracket row and a packed row are DIFFERENT workload
    shapes from their no-EOS / isolated twins, and cross-comparing them
    would report the bracket span as a regression.  The no-EOS /
    isolated spellings stay untagged so legacy records (r01-r05, which
    never name a bracket) keep aligning with their successors."""
    text = metric.lower()
    if "packed" in text:
        mode = "packed"
    elif "full-study" in text or "full row contract" in text:
        mode = "full-study"
    elif "end-to-end" in text:
        mode = "e2e-sweep"
    elif "single forward" in text:
        mode = "single"
    elif "decode, all rows" in text or "all rows" in text:
        mode = "decode-all"
    elif "two-phase" in text:
        mode = "parity"
    else:
        mode = "other"
    tags = []
    m = re.search(r"(\d+)-token prompts", text)
    if m:
        tags.append(f"{m.group(1)}tok")
    if "sweep operating point" in text:
        tags.append("sweep-point")
    tags.extend(_shape_tags(text))
    key = mode + (("@" + "+".join(tags)) if tags else "")
    return f"{key} [{unit}]"


def _shape_tags(text: str) -> List[str]:
    """The workload-SHAPE tags (decode bracket, packing factor, joint
    K-decode block size) that must never cross-compare — shared by
    :func:`metric_key` and the headline key, which is otherwise
    positional.  No-EOS / isolated / sequential (K=1) spellings stay
    untagged so legacy records keep aligning."""
    tags = []
    if "eos-typical" in text:
        tags.append("eos-typical")
    m = re.search(r"(?:q=|packing )(\d+)", text)
    if m:
        tags.append(f"q{m.group(1)}")
    m = re.search(r"decode-k (\d+)", text)
    if m and int(m.group(1)) > 1:
        # a joint-K-decode run is a different workload shape
        # from its sequential twin (the decode legs run different
        # programs); K-tagged rows align only with K-tagged rows
        tags.append(f"k{m.group(1)}")
    return tags


def flatten_metrics(rec: Dict) -> Dict[str, Dict]:
    """``{aligned key: {"value", "unit", "metric"}}`` for the headline +
    every secondary row, plus the bracket and packing blocks: ``brackets`` rows
    (keyed with their eos-mode tag, so a no-EOS row can never
    cross-compare with an EOS-typical one) and the ``packed`` companion
    record.  Key collisions (two secondaries of one class) disambiguate
    by index."""
    # the headline key is positional, EXCEPT for the workload-shape tags:
    # an --eos-mode typical (or packed) headline is a different workload
    # from the default bracket's and must report new/gone, not a verdict
    shape = _shape_tags(rec.get("metric", "").lower())
    head_key = "headline" + (("@" + "+".join(shape)) if shape else "")
    out: Dict[str, Dict] = {
        head_key: {"value": rec["value"], "unit": rec.get("unit", ""),
                   "metric": rec.get("metric", "")},
    }
    extra_rows = list(rec.get("secondary", ()) or ())
    for holder in [rec] + [e for e in extra_rows if isinstance(e, dict)]:
        # bracket rows ride top-level on a direct sweep-full record and
        # NESTED on the parent sweep record's full-study child secondary
        # (the bench child-extras forwarding) — flatten both
        for entry in holder.get("brackets", ()) or ():
            extra_rows.append(dict(entry, metric=entry.get(
                "metric",
                f"({entry.get('eos_mode', '?')} decode bracket)")))
    if isinstance(rec.get("packed"), dict) and "value" in rec["packed"]:
        extra_rows.append(rec["packed"])
    for entry in extra_rows:
        key = metric_key(entry.get("metric", ""), entry.get("unit", ""))
        base, n = key, 2
        while key in out:
            key = f"{base} #{n}"
            n += 1
        out[key] = {"value": entry.get("value"),
                    "unit": entry.get("unit", ""),
                    "metric": entry.get("metric", "")}
    # k_decode blocks ride top-level on a sweep-full record and NESTED on
    # the sweep record's full-study child secondary — flatten both (the
    # brackets discipline); first spelling wins on a key collision
    for holder in [rec] + [e for e in extra_rows if isinstance(e, dict)]:
        for key, row in _k_decode_rows(holder).items():
            out.setdefault(key, row)
    # occupancy blocks (ROADMAP item 3) follow the same two-home rule
    for holder in [rec] + [e for e in extra_rows if isinstance(e, dict)]:
        for key, row in _occupancy_rows(holder).items():
            out.setdefault(key, row)
    out.update(_serve_load_rows(rec))
    out.update(_serve_pool_rows(rec))
    out.update(_recovery_rows(rec))
    return out


def _occupancy_rows(rec: Dict) -> Dict[str, Dict]:
    """Aligned rows from a record's ``occupancy`` block (ROADMAP item 3,
    decode-then-repack): the SLOT-IDLE FRACTION is a lower-is-better
    verdict row (unit ``idle-frac`` — occupancy regressing means the
    repack pipeline stopped refilling lanes), the whole-flush
    counterfactual and refill/stall counts ride along as informational
    rows so an idle-fraction move is explainable in place."""
    block = rec.get("occupancy")
    if not isinstance(block, dict):
        return {}
    out: Dict[str, Dict] = {}
    if block.get("slot_idle_frac") is not None:
        out["slot idle fraction [idle-frac]"] = {
            "value": block["slot_idle_frac"], "unit": "idle-frac",
            "metric": "decode slot-idle fraction under repack "
                      "(lower = fuller lanes)"}
    if block.get("slot_idle_frac_no_repack") is not None:
        out["slot idle fraction (no-repack counterfactual)"] = {
            "value": block["slot_idle_frac_no_repack"], "unit": "",
            "metric": "whole-flush counterfactual slot-idle fraction "
                      "(same rows, legacy schedule)"}
    for name in ("refills", "repack_stalls"):
        if block.get(name) is not None:
            out[f"slot {name.replace('_', ' ')}"] = {
                "value": block[name], "unit": "",
                "metric": f"decode-then-repack {name.replace('_', ' ')} "
                          f"(informational)"}
    return out


def _k_decode_rows(rec: Dict) -> Dict[str, Dict]:
    """Aligned rows from a record's ``k_decode`` block: the
    per-leg steps saved, the mean accepted K, and the block reject rate
    — informational rows (no regression verdict: steps-saved scale with
    corpus size and the reject rate is a prior-calibration input, not a
    perf promise), keyed by the leg name so rounds compare like for
    like."""
    block = rec.get("k_decode")
    if not isinstance(block, dict):
        return {}
    out: Dict[str, Dict] = {}
    k = block.get("decode_k")
    saved = block.get("k_steps_saved") or {}
    for leg in ("confidence", "completion"):
        if saved.get(leg) is not None:
            out[f"k-decode steps-saved ({leg})"] = {
                "value": saved.get(leg), "unit": "",
                "metric": f"joint decode-k {k} steps saved on the {leg} "
                          f"leg (measured repeats)"}
    if block.get("accepted_k_mean") is not None:
        out["k-decode accepted-k mean"] = {
            "value": block["accepted_k_mean"], "unit": "",
            "metric": f"mean accepted block length at decode-k {k}"}
    if block.get("k_reject_rate") is not None:
        out["k-decode reject rate"] = {
            "value": block["k_reject_rate"], "unit": "",
            "metric": f"verify-and-accept block reject rate at "
                      f"decode-k {k}"}
    return out


def _serve_load_rows(rec: Dict) -> Dict[str, Dict]:
    """Aligned rows from a record's ``serve_load`` block: per
    rate point, achieved throughput (higher-better) and p99 end-to-end
    latency (LOWER-better, unit ``ms``), plus the saturation estimate.

    Keyed by SWEEP POSITION, not the offered-rate value: the default
    ``--serve-load-rates auto`` derives each record's rates from its own
    measured offline ceiling, so the floats never repeat across rounds
    and value-keyed rows would all report new/gone instead of comparing.
    Position i is the same BRACKET of the ceiling round over round
    (auto: 0.5x/1.0x/1.5x), which is the comparison that means
    something; the offered rate itself rides along as an informational
    row so a bracket drift is visible next to its latency verdict."""
    block = rec.get("serve_load")
    if not isinstance(block, dict):
        return {}
    out: Dict[str, Dict] = {}
    for i, point in enumerate(block.get("rates", ()) or ()):
        offered = point.get("offered_rate")
        tag = f"serve-load[{i}]"
        out[f"{tag} offered"] = {
            "value": offered, "unit": "",
            "metric": f"serve load sweep point {i} offered rate (rows/s)"}
        out[f"{tag} achieved [rows/sec]"] = {
            "value": point.get("achieved_rows_per_s"), "unit": "rows/sec",
            "metric": f"serve load achieved rate at sweep point {i} "
                      f"({offered} offered)"}
        p99 = (point.get("latency_ms") or {}).get("p99")
        out[f"{tag} p99 [ms]"] = {
            "value": p99, "unit": "ms",
            "metric": f"serve load p99 e2e latency at sweep point {i} "
                      f"({offered} offered)"}
    if block.get("saturation_rows_per_s") is not None:
        out["serve-load saturation [rows/sec]"] = {
            "value": block["saturation_rows_per_s"], "unit": "rows/sec",
            "metric": "serve load saturation throughput"}
    return out


def _pool_roster_tag(entry: Dict) -> str:
    """Cross-round identity of one ``serve_load_pool`` configuration.

    Keyed by ROLE COMPOSITION, not the free-text name: a disaggregated
    roster tags itself ``prefill:N,decode:M`` (sorted so spelling order
    in the flag never splits the series) and compares only with rosters
    of the same composition; symmetric rosters key as ``symmetric-xN``
    by replica count — so the knee-vs-knee comparison
    (disaggregated vs symmetric at equal chips) lands as two adjacent
    verdict rows instead of one mis-aligned one."""
    roles = entry.get("roles")
    if isinstance(roles, dict) and roles:
        return ",".join(f"{r}:{roles[r]}" for r in sorted(roles,
                                                          reverse=True))
    name = str(entry.get("name", ""))
    n = len(entry.get("replicas", ()) or ())
    if name.startswith("single-model"):
        return f"symmetric-x{n}" if n else name
    return name or f"symmetric-x{n}"


def _serve_pool_rows(rec: Dict) -> Dict[str, Dict]:
    """Aligned rows from a record's ``serve_load_pool`` block (the
    fleet and its roles): per roster configuration — keyed by
    :func:`_pool_roster_tag` — the saturation throughput
    (higher-better ``rows/sec``: the roster's knee) and the p99 e2e
    latency at the TOP swept rate (lower-better ``ms``), with the
    replica count riding along informationally so a knee move is
    explainable by a fleet-size change in place."""
    block = rec.get("serve_load_pool")
    if not isinstance(block, dict):
        return {}
    out: Dict[str, Dict] = {}
    for entry in block.get("configurations", ()) or ():
        if not isinstance(entry, dict):
            continue
        tag = _pool_roster_tag(entry)
        sl = entry.get("serve_load")
        if not isinstance(sl, dict):
            continue
        if sl.get("saturation_rows_per_s") is not None:
            out[f"pool[{tag}] saturation [rows/sec]"] = {
                "value": sl["saturation_rows_per_s"], "unit": "rows/sec",
                "metric": f"pool roster {tag} saturation throughput "
                          f"(knee of the rate sweep)"}
        points = sl.get("rates", ()) or ()
        if points:
            p99 = (points[-1].get("latency_ms") or {}).get("p99")
            if p99 is not None:
                out[f"pool[{tag}] p99@top [ms]"] = {
                    "value": p99, "unit": "ms",
                    "metric": f"pool roster {tag} p99 e2e latency at "
                              f"the top swept rate"}
        n = len(entry.get("replicas", ()) or ())
        if n:
            out[f"pool[{tag}] replicas"] = {
                "value": n, "unit": "",
                "metric": f"pool roster {tag} replica count "
                          f"(informational)"}
    return out


def _recovery_rows(rec: Dict) -> Dict[str, Dict]:
    """Aligned rows from a record's ``recovery`` block: the
    self-healing drill that ``--serve-load-faults`` runs.  Detection and
    restart latency are lower-is-better ``ms`` rows; ``requests_lost``
    carries the zero-tolerance ``lost-requests`` unit — the contract is
    that every request is ANSWERED (a result or a typed rejection), so a
    single lost request is a hard regression regardless of percentage.
    Incident, failover and restart counts ride along informationally:
    their absolute values track the injected fault schedule, not code
    quality, so no verdict is attached to them."""
    block = rec.get("recovery")
    if not isinstance(block, dict):
        return {}
    out: Dict[str, Dict] = {}
    det = block.get("detection_ms") or {}
    if det.get("mean") is not None:
        out["recovery detection mean [ms]"] = {
            "value": det["mean"], "unit": "ms",
            "metric": "mean fault-to-quarantine detection latency over "
                      f"{det.get('n')} incident(s)"}
    rst = block.get("restart_ms") or {}
    if rst.get("mean") is not None:
        out["recovery restart mean [ms]"] = {
            "value": rst["mean"], "unit": "ms",
            "metric": "mean quarantine-to-live replica rebuild latency "
                      f"over {rst.get('n')} rebuild(s)"}
    if block.get("requests_lost") is not None:
        out["recovery lost [lost-requests]"] = {
            "value": block["requests_lost"], "unit": "lost-requests",
            "metric": "requests neither answered nor rejected under "
                      "injected faults (must stay 0)"}
    for key, label in (("requests_failed_over", "failed-over"),
                       ("incidents", "incidents"),
                       ("restarts", "restarts")):
        if block.get(key) is not None:
            out[f"recovery {label}"] = {
                "value": block[key], "unit": "",
                "metric": f"self-healing {label.replace('-', ' ')} count "
                          "under the injected fault schedule"}
    return out


def _pct(old: Optional[float], new: Optional[float]) -> Optional[float]:
    if old is None or new is None or not old:
        return None
    return (new - old) / old * 100.0


def diff_records(records: Sequence[Dict],
                 threshold_pct: float = 5.0) -> Dict:
    """Align ``records`` (round order) and classify every metric row.

    Returns ``{"labels", "metrics": [row...], "phases": [row...],
    "context": [row...], "regressions": [...]}`` where each metric row is
    ``{key, values, delta_pct, verdict}`` over the FIRST→LAST pair (the
    middle rounds print for trajectory context)."""
    labels = [r["label"] for r in records]
    flats = [flatten_metrics(r) for r in records]
    keys: List[str] = []
    for flat in flats:
        for k in flat:
            if k not in keys:
                keys.append(k)
    metrics, regressions = [], []
    for key in keys:
        values = [flat.get(key, {}).get("value") for flat in flats]
        unit = next((flat[key]["unit"] for flat in flats if key in flat), "")
        first = next((v for v in values if v is not None), None)
        last = next((v for v in reversed(values) if v is not None), None)
        delta = _pct(first, last)
        if unit in _HARD_ZERO_UNITS:
            # zero-tolerance rows: any non-zero value in the newest
            # round is a regression outright — no threshold, and "new"
            # is no excuse (the first round the row shows up non-zero
            # is exactly when it must scream)
            if last:
                verdict = "REGRESSION"
            elif values[-1] is None:
                verdict, delta = "gone", None
            else:
                verdict, delta = "ok", None
        elif values[0] is None:
            verdict, delta = "new", None
        elif values[-1] is None:
            verdict, delta = "gone", None
        elif delta is None:
            verdict = "n/a"
        elif unit in _HIGHER_IS_BETTER_UNITS and delta < -threshold_pct:
            verdict = "REGRESSION"
        elif unit in _HIGHER_IS_BETTER_UNITS and delta > threshold_pct:
            verdict = "improved"
        elif unit in _LOWER_IS_BETTER_UNITS and delta > threshold_pct:
            verdict = "REGRESSION"   # latency rows: growth is the bug
        elif unit in _LOWER_IS_BETTER_UNITS and delta < -threshold_pct:
            verdict = "improved"
        else:
            verdict = "ok"
        row = {"key": key, "unit": unit, "values": values,
               "delta_pct": None if delta is None else round(delta, 2),
               "verdict": verdict}
        metrics.append(row)
        if verdict == "REGRESSION":
            regressions.append(row)

    phases = []
    phase_blocks = [r.get("phases") or {} for r in records]
    if sum(1 for b in phase_blocks if b.get("per_phase")) >= 2:
        names: List[str] = []
        for block in phase_blocks:
            for name in block.get("per_phase", {}):
                if name not in names:
                    names.append(name)
        for name in names:
            values = [
                (block.get("per_phase", {}).get(name) or {}).get(
                    "ms_per_row",
                    (block.get("per_phase", {}).get(name) or {}).get(
                        "seconds"))
                for block in phase_blocks
            ]
            first = next((v for v in values if v is not None), None)
            last = next((v for v in reversed(values) if v is not None),
                        None)
            delta = _pct(first, last)
            # phase cost: LOWER is better
            if values[0] is None:
                verdict, delta = "new", None
            elif values[-1] is None:
                verdict, delta = "gone", None
            elif delta is not None and delta > threshold_pct:
                verdict = "REGRESSION"
            elif delta is not None and delta < -threshold_pct:
                verdict = "improved"
            else:
                verdict = "ok"
            row = {"key": f"phase:{name}", "unit": "ms/row",
                   "values": values,
                   "delta_pct": None if delta is None else round(delta, 2),
                   "verdict": verdict}
            phases.append(row)
            if verdict == "REGRESSION":
                regressions.append(row)

    context = []
    ctx_blocks = [r.get("context") or {} for r in records]
    if sum(1 for b in ctx_blocks if b) >= 2:
        names = []
        for block in ctx_blocks:
            for name in block:
                if name not in names:
                    names.append(name)
        for name in names:
            values = [block.get(name) for block in ctx_blocks]
            if all(v == values[0] for v in values):
                continue                    # unchanged context is noise
            context.append({"key": f"context:{name}", "values": values})

    return {"labels": labels, "threshold_pct": threshold_pct,
            "metrics": metrics, "phases": phases, "context": context,
            "regressions": regressions}


def format_diff_table(diff: Dict) -> str:
    """The aligned regression table (stdout)."""
    labels = diff["labels"]
    width = max([len("metric")] + [len(r["key"])
                                   for r in diff["metrics"] + diff["phases"]
                                   + diff["context"]])

    def fmt(v):
        if v is None:
            return "-"
        if isinstance(v, float):
            return f"{v:.2f}"
        return str(v)

    lines = [
        f"# bench trajectory: {' -> '.join(labels)} "
        f"(threshold {diff['threshold_pct']:g}%)",
        "  " + "metric".ljust(width) + "  "
        + "  ".join(f"{lab:>10}" for lab in labels)
        + f"  {'delta':>9}  verdict",
    ]
    for row in diff["metrics"] + diff["phases"]:
        delta = ("" if row["delta_pct"] is None
                 else f"{row['delta_pct']:+8.2f}%")
        lines.append(
            "  " + row["key"].ljust(width) + "  "
            + "  ".join(f"{fmt(v):>10}" for v in row["values"])
            + f"  {delta:>9}  {row['verdict']}")
    for row in diff["context"]:
        lines.append(
            "  " + row["key"].ljust(width) + "  "
            + "  ".join(f"{fmt(v):>10}" for v in row["values"]))
    n_reg = len(diff["regressions"])
    lines.append(f"  {n_reg} regression(s) beyond "
                 f"{diff['threshold_pct']:g}%"
                 + ("" if not n_reg else ": "
                    + ", ".join(r["key"] for r in diff["regressions"])))
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``obs bench-diff`` CLI body (routed from obs/report.py)."""
    parser = argparse.ArgumentParser(
        prog="llm_interpretation_replication_tpu_torch obs bench-diff",
        description="align two or more BENCH_r*.json records and print a "
                    "regression table over the perf trajectory")
    parser.add_argument("records", nargs="+", metavar="BENCH.json",
                        help="two or more bench records, oldest first "
                             "(run wrapper or bare bench JSON line)")
    parser.add_argument("--threshold", type=float, default=5.0,
                        metavar="PCT",
                        help="regression threshold in percent (throughput "
                             "drop / phase ms-per-row growth beyond this "
                             "fails; default 5)")
    parser.add_argument("--format", choices=["table", "json"],
                        default="table")
    parser.add_argument("--no-fail", action="store_true",
                        help="always exit 0 (report-only mode; default "
                             "exits 1 when any regression exceeds the "
                             "threshold)")
    args = parser.parse_args(argv)
    if len(args.records) < 2:
        parser.error("need at least two records to diff")
    try:
        records = [load_bench_record(p) for p in args.records]
    except (OSError, ValueError) as err:
        print(f"obs bench-diff: {err}", file=sys.stderr)
        return 2
    diff = diff_records(records, threshold_pct=args.threshold)
    if args.format == "json":
        print(json.dumps(diff, indent=2))
    else:
        print(format_diff_table(diff))
    if diff["regressions"] and not args.no_fail:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
