"""Open-loop load harness + per-request latency anatomy for serve/ (the
JAX package's ``serve/load.py``).

Everything the repo measured before this module was CLOSED-loop: the
sweep shells and the replay harness submit work as fast as the engine
drains it, so "rows/s" is a throughput ceiling and the latency samples
only describe a system that is never waiting on traffic.  Serving
economics need the other curve: hold the ARRIVAL rate fixed
regardless of completions (open loop — no coordinated omission), walk it
across a sweep of offered rates, and watch where tail latency leaves the
floor.  That knee, not the ceiling, is what a fleet is provisioned by.

Three cooperating pieces:

- :func:`poisson_schedule` — seeded exponential inter-arrivals at a
  configurable offered rate; same seed ⇒ bit-identical schedule, so a
  latency comparison across two builds replays the same traffic.
  Prompts are drawn (seeded) from the REAL perturbation corpus
  (:func:`corpus_workload`), so the prompt-length mix is the production
  heavy-tail one, not a synthetic constant.
- :func:`run_load` — drive the existing :class:`~.scheduler.Scheduler`
  in-process at one offered rate (or ``mode="closed"`` as the
  comparator), collect per-request end-to-end latency decomposed into
  the scheduler's span phases (queue_wait / coalesce / serve_engine / respond
  — :data:`~.scheduler.HIST_PHASES`, stamped by the scheduler onto each
  future), and report percentiles from the telemetry layer's
  log-bucketed streaming histograms — EXACT counts, no eviction: the
  bounded sample rings truncate to the newest 4096 values, which is
  precisely the history a p99.9 lives in.  The report carries the ring
  truncation block next to the histogram numbers so the two windows can
  never be confused.  A parity leg re-scores the served prompts offline
  and asserts bit-identical rows — load changes WHEN a row is computed,
  never WHAT.
- :func:`rate_sweep` — the knee finder: walk >= 3 offered rates,
  emit per-rate p50/p90/p99/p99.9 + per-phase medians +
  achieved-vs-offered + queue-depth trajectory, and estimate saturation
  throughput.  ``bench.py --serve-load`` attaches this block to the
  JSON record; ``obs bench-diff`` aligns it across records and ``obs
  report --serve-load`` renders the per-phase table.

Measurement-only: the harness submits ordinary :class:`ScoreRequest`\\ s
through the public scheduler surface; nothing here touches the scoring
path.
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import telemetry
from .config import SchedulerConfig
from .replay import _per_request_targets, rows_equal
from .request import ScoreRequest, ServeError
from .scheduler import HIST_E2E, HIST_PHASES, Scheduler

#: report percentiles — p99.9 is the one the bounded rings cannot keep.
LOAD_PCTS = (50.0, 90.0, 99.0, 99.9)

#: queue-depth trajectory sampling interval / retained points.
DEPTH_SAMPLE_S = 0.05
DEPTH_TRAJECTORY_POINTS = 64

#: Knee criterion: a rate point "keeps up" when nothing was shed or
#: failed AND its post-arrival DRAIN (makespan minus the last scheduled
#: arrival — how long the queue took to clear once traffic stopped)
#: stayed within the sweep's sub-saturation floor (the smallest drain of
#: any swept rate: one in-flight latency) plus this slack.  Drain, not
#: achieved/offered: the makespan includes the final requests' natural
#: service latency, so an achieved-rate ratio misclassifies honest
#: sub-saturation points whenever per-request latency is non-trivial
#: relative to the arrival window; drain at sub-saturation is one
#: latency regardless of duration, while at saturation it grows with
#: the backlog.
KNEE_DRAIN_WINDOW_FRACTION = 0.15
KNEE_DRAIN_SLACK_S = 0.5

#: The drain floor is RELATIVE (the sweep's smallest drain), which
#: assumes at least one swept rate is below saturation (the auto
#: bracket's 0.5x anchor guarantees one).  When even the lowest rate
#: spent more than this fraction of the arrival window draining its
#: backlog, EVERY point was saturated, the relative floor is
#: meaningless, and the knee is reported as unknown (None +
#: ``knee_floor_saturated``) instead of confidently naming a saturated
#: operating point as "keeping up".
KNEE_FLOOR_MAX_DRAIN_FRACTION = 0.5


def poisson_schedule(rate: float, duration_s: float,
                     seed: int = 0) -> List[float]:
    """Seeded open-loop arrival offsets (seconds from t0) for a Poisson
    process at ``rate`` requests/s over ``duration_s``.  Deterministic:
    the same (rate, duration, seed) yields the identical schedule."""
    if rate <= 0:
        raise ValueError(f"offered rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    out: List[float] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / rate))
        if t >= duration_s:
            return out
        out.append(t)


def corpus_workload(path: str, max_rephrasings: Optional[int] = None
                    ) -> Tuple[List[str], List[Tuple[str, str]]]:
    """The perturbation corpus as a (prompts, per-prompt target pairs)
    pool — the same ``{rephrasing} {response_format}`` spelling the
    offline sweep shell and ``serve --replay`` build, so the load mix
    carries the production prompt-length histogram."""
    with open(path, encoding="utf-8") as f:
        scenarios = json.load(f)
    prompts, targets = [], []
    for s in scenarios:
        rephrasings = s["rephrasings"]
        if max_rephrasings is not None:
            rephrasings = rephrasings[:max_rephrasings]
        for r in rephrasings:
            prompts.append(f"{r} {s['response_format']}")
            targets.append(tuple(s["target_tokens"][:2]))
    return prompts, targets


def _phase_report(hist_delta: Dict[str, Dict]) -> Dict[str, Dict]:
    """Per-phase percentiles from a :func:`telemetry.hist_since` delta."""
    out = {}
    for phase, hist_name in HIST_PHASES.items():
        entry = hist_delta.get(hist_name)
        if entry:
            pct = telemetry.hist_percentiles_from(entry["counts"], LOAD_PCTS)
            pct["mean"] = round(entry["sum"] / entry["count"], 3)
            out[phase] = {k: round(v, 3) for k, v in pct.items()}
    return out


def _downsample(points: List, cap: int = DEPTH_TRAJECTORY_POINTS) -> List:
    if len(points) <= cap:
        return points
    step = len(points) / cap
    return [points[min(len(points) - 1, int(i * step))] for i in range(cap)]


class _DepthSampler:
    """Queue-depth trajectory: a daemon thread sampling ``len(queue)``
    every :data:`DEPTH_SAMPLE_S` for the duration of one load run."""

    def __init__(self, sched: Scheduler, t0: float):
        self.samples: List[Tuple[float, int]] = []
        self._stop = threading.Event()

        def loop():
            while not self._stop.wait(DEPTH_SAMPLE_S):
                self.samples.append(
                    (round(time.monotonic() - t0, 3), len(sched.queue)))

        self._thread = threading.Thread(target=loop, name="serve-load-depth",
                                        daemon=True)
        self._thread.start()

    def close(self) -> Dict:
        self._stop.set()
        self._thread.join(timeout=2.0)
        depths = [d for _, d in self.samples]
        if not depths:
            return {"max": 0, "mean": 0.0, "trajectory": []}
        return {
            "max": int(max(depths)),
            "mean": round(sum(depths) / len(depths), 2),
            "trajectory": _downsample(self.samples),
        }


def run_load(engine, prompts: Sequence, targets=("Yes", "No"),
             rate: float = 10.0, duration_s: float = 5.0, seed: int = 0,
             mode: str = "open", concurrency: int = 4,
             with_confidence: bool = False,
             max_new_tokens: Optional[int] = None,
             config: Optional[SchedulerConfig] = None,
             offline_rows: Optional[List[Dict]] = None,
             parity: bool = True,
             jsonl=None,
             result_timeout_s: float = 600.0,
             scheduler_factory=None) -> Dict:
    """Drive the scheduler at one operating point and report the latency
    anatomy.

    ``mode="open"``: submissions follow the seeded Poisson schedule
    regardless of completions — the generator never waits, so queueing
    delay is measured honestly (no coordinated omission).  A submit
    rejected by backpressure counts as ``shed``, not as latency.
    ``mode="closed"``: ``concurrency`` workers submit-wait-loop for
    ``duration_s`` — the throughput-ceiling comparator.

    ``offline_rows`` (aligned with ``prompts``) supplies the parity
    reference; without it and with ``parity=True`` the harness scores
    the prompt pool offline FIRST (which also warms the compiled
    shapes, so the load run measures steady-state serving).  ``jsonl``
    (path or open file) streams one per-request anatomy line.
    ``result_timeout_s`` is ONE shared budget for the whole
    result-collection phase — a wedged scheduler costs it once, never
    once per outstanding request.

    ``scheduler_factory(cfg)`` (optional) supplies the front door the
    harness drives INSTEAD of building ``Scheduler(engine, cfg)`` — the
    EnginePool measures its fleet through the SAME harness by handing
    ``pool.client(model)`` here (a Scheduler-shaped facade whose
    ``close()`` is a no-op: the pool outlives one load run, its
    lifetime owned by the caller).  ``engine`` is still the offline
    parity reference — for a pool of local replicas the served rows
    must be bit-identical to any single replica's ``score_prompts``."""
    prompts = list(prompts)
    per_targets = _per_request_targets(targets, len(prompts))
    if mode not in ("open", "closed"):
        raise ValueError(f"mode must be 'open' or 'closed', got {mode!r}")

    if parity and offline_rows is None:
        offline_rows = engine.score_prompts(
            prompts, targets=targets, with_confidence=with_confidence,
            max_new_tokens=max_new_tokens)

    cfg = config or SchedulerConfig()
    schedule = (poisson_schedule(rate, duration_s, seed)
                if mode == "open" else [])
    pick_rng = np.random.default_rng([seed, len(prompts)])

    close_jsonl = False
    if isinstance(jsonl, str):
        jsonl = open(jsonl, "w", encoding="utf-8")
        close_jsonl = True

    counters0 = telemetry.counters()
    hists0 = telemetry.hist_snapshot(
        [HIST_E2E] + list(HIST_PHASES.values()))
    records: List[Dict] = []   # {"i", "scheduled_s", "lag_ms",
    #                             "prompt_idx", "future"}
    shed = 0
    sched = (scheduler_factory(cfg) if scheduler_factory is not None
             else Scheduler(engine, cfg).start())
    if getattr(sched, "follower", False):
        # a follower rank of a mesh: the leader draws the arrivals and
        # reports; this rank runs its engine calls until it closes
        sched.close()
        if close_jsonl:
            jsonl.close()
        return {"mode": mode, "follower": True,
                "engine_calls": sched.engine_calls}
    t0 = time.monotonic()
    depth = _DepthSampler(sched, t0)
    try:
        if mode == "open":
            picks = pick_rng.integers(0, len(prompts), size=len(schedule))
            for i, offset in enumerate(schedule):
                delay = t0 + offset - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                idx = int(picks[i])
                # mode + offered rate ride every line: a rate_sweep
                # streams all its points (and the closed comparator)
                # into ONE jsonl, so each record must name its point
                rec = {"i": i, "mode": "open",
                       "offered_rate": round(rate, 3),
                       "scheduled_s": round(offset, 6),
                       "prompt_idx": idx, "future": None}
                rec["lag_ms"] = round(
                    (time.monotonic() - (t0 + offset)) * 1000.0, 3)
                try:
                    rec["future"] = sched.submit(ScoreRequest(
                        prompt=prompts[idx], targets=per_targets[idx],
                        with_confidence=with_confidence,
                        max_new_tokens=max_new_tokens))
                except ServeError as err:
                    # open loop: typed backpressure/shutdown sheds the
                    # arrival and the generator keeps its schedule —
                    # waiting here would silently turn the harness
                    # closed-loop
                    shed += 1
                    rec["error_type"] = type(err).__name__
                records.append(rec)
        else:
            lock = threading.Lock()
            state = {"n": 0}
            deadline = t0 + duration_s

            def worker():
                while time.monotonic() < deadline:
                    with lock:
                        i = state["n"]
                        state["n"] += 1
                    idx = i % len(prompts)   # deterministic round-robin
                    rec = {"i": i, "mode": "closed", "offered_rate": None,
                           "scheduled_s": None, "lag_ms": 0.0,
                           "prompt_idx": idx, "future": None}
                    try:
                        rec["future"] = sched.submit(ScoreRequest(
                            prompt=prompts[idx], targets=per_targets[idx],
                            with_confidence=with_confidence,
                            max_new_tokens=max_new_tokens))
                        rec["future"].result(timeout=result_timeout_s)
                    except Exception as err:  # graftlint: disable=G05 harness result relay: the scheduler already classified the error (OOM split/typed rejection) before it landed on the future; the worker records it as this request's data point and keeps offering load
                        rec["error_type"] = type(err).__name__
                    with lock:
                        records.append(rec)

            workers = [threading.Thread(target=worker, daemon=True,
                                        name=f"serve-load-closed-{k}")
                       for k in range(max(1, concurrency))]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=result_timeout_s + duration_s)
            records.sort(key=lambda r: r["i"])

        completed, errors = 0, 0
        errors_by_type: Dict[str, int] = {}
        mismatched: List[int] = []
        # ONE shared budget for the whole collection phase, not one per
        # future: a wedged scheduler must cost result_timeout_s once,
        # never N x result_timeout_s (resolved futures return instantly,
        # so a healthy run never notices the shared deadline)
        wait_deadline = time.monotonic() + result_timeout_s
        for rec in records:
            fut = rec.pop("future", None)
            if fut is None:
                if mode == "closed":   # open mode counted the shed at
                    shed += 1          # submit time
            else:
                try:
                    row = fut.result(timeout=max(
                        0.0, wait_deadline - time.monotonic()))
                except Exception as err:  # graftlint: disable=G05 harness result relay: the scheduler already classified the error (OOM split/typed rejection) before it landed on the future; the report counts it instead of sinking the other requests' anatomy
                    errors += 1
                    rec["error_type"] = type(err).__name__
                    errors_by_type[rec["error_type"]] = (
                        errors_by_type.get(rec["error_type"], 0) + 1)
                else:
                    completed += 1
                    rec["ok"] = True
                    if fut.timing is not None:
                        rec.update({k: round(v, 3)
                                    for k, v in fut.timing.items()})
                    if offline_rows is not None and not rows_equal(
                            row, offline_rows[rec["prompt_idx"]]):
                        mismatched.append(rec["i"])
            if jsonl is not None:
                jsonl.write(json.dumps(rec) + "\n")
        makespan_s = time.monotonic() - t0
    finally:
        depth_report = depth.close()
        sched.close()
        if close_jsonl:
            jsonl.close()
        elif jsonl is not None:
            jsonl.flush()

    delta = telemetry.counters_since(counters0)
    hist_delta = telemetry.hist_since(hists0)
    e2e = hist_delta.get(HIST_E2E)
    latency = (telemetry.hist_percentiles_from(e2e["counts"], LOAD_PCTS)
               if e2e else {})
    if e2e:
        latency["mean"] = e2e["sum"] / e2e["count"]
    lags = sorted(r.get("lag_ms", 0.0) for r in records)
    rings = telemetry.sample_ring_report(
        ["serve_queue_wait_ms", "serve_latency_ms", "serve_queue_depth"])
    report = {
        "mode": mode,
        "seed": seed,
        "offered_rate": round(rate, 3) if mode == "open" else None,
        "concurrency": concurrency if mode == "closed" else None,
        "duration_s": round(duration_s, 3),
        "makespan_s": round(makespan_s, 3),
        "requests": len(records),
        "completed": completed,
        "errors": errors,
        # typed-vs-lost split: a typed rejection (DeadlineExceeded,
        # PoisonousRequest, ...) is an ANSWERED request; a TimeoutError
        # here means the future never resolved inside the shared budget
        # — the "lost" signal the self-healing recovery block audits
        "errors_by_type": errors_by_type,
        "shed": shed,
        "achieved_rows_per_s": (round(completed / makespan_s, 2)
                                if makespan_s > 0 else None),
        # post-arrival drain: how long the queue took to clear after the
        # last scheduled arrival — ~one in-flight latency below
        # saturation, grows with the backlog above it (the knee signal)
        "drain_s": round(max(0.0, makespan_s - (schedule[-1] if schedule
                                                else duration_s)), 3),
        # exact-count log-bucketed histograms (telemetry.record_hist):
        # every request of this run is in the window — the p99.9 the
        # bounded rings would have evicted is the point of the exercise
        "latency_ms": {k: round(v, 3) for k, v in latency.items()},
        "phases_ms": _phase_report(hist_delta),
        "hist_requests": int(e2e["count"]) if e2e else 0,
        # open-loop honesty: how far the generator itself drifted off
        # the schedule (a lagging generator under-offers load)
        "gen_lag_ms_p99": (round(lags[max(0, math.ceil(
            0.99 * len(lags)) - 1)], 3) if lags else None),
        "queue_depth": depth_report,
        "blocked_transfers": int(delta.get("blocked_transfers", 0)),
        # ring-truncation visibility (satellite): the bounded sample
        # rings next door may have truncated (total > retained) — a
        # reader comparing ring percentiles to the histogram numbers
        # sees which window each describes
        "samples": rings,
        "rings_truncated": any(m["total"] > m["retained"]
                               for m in rings.values()),
    }
    if offline_rows is not None:
        report["parity"] = {
            "checked_rows": completed,
            "mismatched_rows": len(mismatched),
            "mismatched_indices": mismatched[:20],
        }
    return report


def rate_sweep(engine, prompts: Sequence, targets=("Yes", "No"),
               rates: Sequence[float] = (), duration_s: float = 5.0,
               seed: int = 0, config: Optional[SchedulerConfig] = None,
               offline_rows: Optional[List[Dict]] = None,
               parity: bool = True, jsonl=None,
               closed_comparator: bool = False,
               result_timeout_s: float = 600.0,
               scheduler_factory=None) -> Dict:
    """The ``serve_load`` block: walk >= 3 offered rates (ascending)
    through :func:`run_load`, estimate saturation throughput and the
    knee, and optionally append the closed-loop comparator point.
    ``scheduler_factory`` forwards to :func:`run_load` — the EnginePool
    rides the same sweep (one pool serves every rate point)."""
    rates = sorted(float(r) for r in rates)
    if len(rates) < 3:
        raise ValueError(f"rate_sweep needs >= 3 offered rates to "
                         f"bracket a knee, got {rates}")
    if parity and offline_rows is None:
        # ONE offline pass serves as parity reference for every rate
        # point (and warms the compiled shapes before the first run)
        offline_rows = engine.score_prompts(list(prompts), targets=targets)

    close_jsonl = False
    if isinstance(jsonl, str):
        jsonl = open(jsonl, "w", encoding="utf-8")
        close_jsonl = True
    try:
        points = [
            run_load(engine, prompts, targets=targets, rate=rate,
                     duration_s=duration_s, seed=seed, mode="open",
                     config=config, offline_rows=offline_rows,
                     parity=parity, jsonl=jsonl,
                     result_timeout_s=result_timeout_s,
                     scheduler_factory=scheduler_factory)
            for rate in rates
        ]
        closed = None
        if closed_comparator:
            closed = run_load(engine, prompts, targets=targets,
                              duration_s=duration_s, seed=seed,
                              mode="closed", config=config,
                              offline_rows=offline_rows, parity=parity,
                              jsonl=jsonl,
                              result_timeout_s=result_timeout_s,
                              scheduler_factory=scheduler_factory)
    finally:
        if close_jsonl:
            jsonl.close()
    if points[0].get("follower"):
        return {"follower": True, "rates": points, "closed_loop": closed,
                "parity_ok": None}

    achieved = [p["achieved_rows_per_s"] or 0.0 for p in points]
    base_drain = min(p["drain_s"] for p in points)
    floor_saturated = (base_drain
                       > KNEE_FLOOR_MAX_DRAIN_FRACTION * duration_s)
    drain_bound = base_drain + max(KNEE_DRAIN_SLACK_S,
                                   KNEE_DRAIN_WINDOW_FRACTION * duration_s)
    keeping_up = [] if floor_saturated else [
        p for p in points
        if not p["shed"] and not p["errors"]
        and p["drain_s"] <= drain_bound]
    knee = keeping_up[-1]["offered_rate"] if keeping_up else None
    block = {
        "mode": "open-loop poisson",
        "seed": seed,
        "duration_s": round(duration_s, 3),
        "rates": points,
        "saturation_rows_per_s": round(max(achieved), 2) if achieved else None,
        # the knee: the highest offered rate the scheduler still keeps
        # up with (nothing shed/failed, post-arrival drain within the
        # sub-saturation floor — KNEE_DRAIN_* above).  When even the
        # top swept rate keeps up, the knee is beyond the sweep —
        # reported honestly instead of pretending the last point is it
        "knee_offered_rate": knee,
        "knee_beyond_sweep": bool(keeping_up) and (
            keeping_up[-1] is points[-1]),
        # every swept rate saturated (relative drain floor unusable):
        # the knee is BELOW the sweep, not at its lowest point
        "knee_floor_saturated": floor_saturated,
        "parity_ok": all(
            (p.get("parity") or {}).get("mismatched_rows", 0) == 0
            for p in points) if parity else None,
    }
    if closed is not None:
        block["closed_loop"] = closed
    return block


def format_rate_table(block: Dict) -> str:
    """Human summary of a ``serve_load`` block (stderr / obs report)."""
    lines = [f"# serve load ({block.get('mode', '?')}, seed "
             f"{block.get('seed')}, {block.get('duration_s')}s/rate):"]
    header = (f"  {'offered':>8} {'achieved':>9} {'shed':>5} "
              + " ".join(f"{('p%g' % p):>9}" for p in LOAD_PCTS)
              + "   phase medians (ms)")
    lines.append(header)
    for p in block.get("rates", ()):
        lat = p.get("latency_ms", {})
        phases = p.get("phases_ms", {})
        med = ", ".join(
            f"{name} {phases[name]['p50']:g}"
            for name in ("queue_wait", "coalesce", "serve_engine",
                         "respond") if name in phases)
        lines.append(
            f"  {p.get('offered_rate') or 0:>8.2f} "
            f"{p.get('achieved_rows_per_s') or 0:>9.2f} "
            f"{p.get('shed', 0):>5d} "
            + " ".join(f"{lat.get('p%g' % q, float('nan')):>9.2f}"
                       for q in LOAD_PCTS)
            + f"   {med}")
    closed = block.get("closed_loop")
    if closed:
        lines.append(f"  closed-loop comparator: "
                     f"{closed.get('achieved_rows_per_s')} rows/s at "
                     f"concurrency {closed.get('concurrency')}")
    if block.get("knee_floor_saturated"):
        knee_txt = "unknown — every swept rate saturated (sweep lower)"
    elif block.get("knee_beyond_sweep"):
        knee_txt = f"beyond sweep (>= {block.get('knee_offered_rate')} offered)"
    else:
        knee_txt = f"at {block.get('knee_offered_rate')} offered"
    lines.append(
        f"  saturation {block.get('saturation_rows_per_s')} rows/s; "
        f"knee {knee_txt}")
    return "\n".join(lines)
