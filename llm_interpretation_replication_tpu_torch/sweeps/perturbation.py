"""The 10k-perturbation sweep on a local model (a copy of
``sweeps/perturbation.py``'s ``run_model_perturbation_sweep``,
``run_packed_perturbation_sweep``, ``load_existing_rows``,
``load_existing_keys`` and ``_sidelog_path``).

Per scenario (5 x 2000 rephrasings) a binary leg scores the scenario's two
target tokens at the first generated position, read under a top-20 filter,
and a confidence leg greedy-generates a short answer parsed for its first
integer plus a digit-weighted confidence.  The output workbook has the
15-column schema of ``sweeps.writers.PERTURBATION_COLUMNS``.  Resume: rows
already in the workbook or its side-log are skipped by (model,
original_main, rephrased_main).  The packed sweep scores Q rephrasings a
prefill (``scoring.packed``), binary leg only, and returns a drift block
against isolated scoring beside its rows.

Run health (``obs/``): the checkpoint flushes and row building record
spans, the flight recorder is armed at the workbook's directory (an
OOM-ladder walk, retry exhaustion, preemption or a watchdog trip leaves a
``flightrec-*.json`` there), and each chunk's heartbeat prints the
``[heartbeat]`` line, sets the progress gauges and beats the stall
watchdog, which warns (never kills) when no chunk completes within k x
the trailing median chunk time.

Departure from the reference: the rows come back as a list of dicts in
``PERTURBATION_COLUMNS`` order, not a ``DataFrame``.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import flight as obs_flight
from ..obs import metrics as obs_metrics
from ..obs import tracer as obs
from ..runtime import faults
from ..runtime.batching import HostPrefetcher
from ..runtime.engine import LegSpec
from ..scoring import packed as packed_mod
from ..scoring.confidence import extract_first_int
from ..utils.checkpoint import append_jsonl, from_writing_rank, writing_rank
from ..utils.logging import SessionLogger
from ..utils.telemetry import counters, counters_since, record_fault
from ..utils.xlsx import read_xlsx, write_xlsx
from .writers import PERTURBATION_COLUMNS, perturbation_row

TOP_LOGPROBS = 20  # the API extractor scans the top 20 of the first token


def _sidelog_path(output_xlsx: str) -> str:
    return output_xlsx + ".rows.jsonl"


@contextlib.contextmanager
def _closing(prefetcher):
    """contextlib.closing that tolerates None (no prefetcher in play)."""
    try:
        yield prefetcher
    finally:
        if prefetcher is not None:
            prefetcher.close()


def _row_key(row: Dict) -> Tuple:
    return (row["Model"], row["Original Main Part"], row["Rephrased Main Part"])


def load_existing_rows(output_xlsx: str) -> Tuple[List[Dict], set]:
    """All checkpointed rows of a sweep's output: the rendered workbook plus
    any side-log rows a crash left unrendered.  Returns (rows, key set).

    The side-log (``<output>.rows.jsonl``) is the sweep's append-only
    checkpoint: each flush appends its new rows there, O(new rows), and the
    workbook is rendered from the full row list once, at the end of the
    sweep, after which the side-log is deleted.  Under a world of ranks
    every rank gets rank 0's rows (``utils.checkpoint.from_writing_rank``),
    so all of them resume from the same rows."""
    return from_writing_rank(lambda: _read_existing_rows(output_xlsx))


def _read_existing_rows(output_xlsx: str) -> Tuple[List[Dict], set]:
    rows: List[Dict] = []
    if os.path.exists(output_xlsx):
        rows = read_xlsx(output_xlsx)[1]
    seen = {_row_key(r) for r in rows}
    sidelog = _sidelog_path(output_xlsx)
    if os.path.exists(sidelog):
        with open(sidelog) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    # a hard kill mid-append can tear the trailing line
                    # (fsync covers completed flushes, not one in
                    # progress); its chunk re-scores on resume
                    continue
                key = _row_key(row)
                if key not in seen:
                    rows.append(row)
                    seen.add(key)
    return rows, seen


def load_existing_keys(output_xlsx: str) -> set:
    return load_existing_rows(output_xlsx)[1]


class _Checkpoint:
    """A sweep's rows on their way to the workbook: :meth:`flush` appends
    the pending rows to the side-log, fsync'd, O(new rows); the final
    flush renders the workbook from every row and deletes the side-log.  A
    latch keeps the PreemptionGuard's handler, which runs in the sweep's
    own thread, from re-entering a flush mid-append (the pending rows would
    land twice, as torn lines); the interrupted append's buffer lands as
    its file closes."""

    def __init__(self, output_xlsx: str, rows: List[Dict]):
        self.output_xlsx = output_xlsx
        self.sidelog = _sidelog_path(output_xlsx)
        self.rows = rows
        self.pending: List[Dict] = []
        self._in_flush = False
        os.makedirs(os.path.dirname(os.path.abspath(output_xlsx)),
                    exist_ok=True)

    def flush(self, final: bool = False) -> None:
        if self._in_flush:
            return
        self._in_flush = True
        try:
            with obs.span("checkpoint_flush", phase="host_write",
                          rows=len(self.pending), final=final):
                if self.pending:
                    append_jsonl(self.sidelog, self.pending)
                    self.rows.extend(self.pending)
                    self.pending = []
                # under a world of ranks rank 0 alone writes (the side-log
                # append above is gated the same way)
                if final and writing_rank():
                    write_xlsx(PERTURBATION_COLUMNS, self.rows,
                               self.output_xlsx)
                    if os.path.exists(self.sidelog):
                        os.remove(self.sidelog)
        finally:
            self._in_flush = False


def _todo_items(scenarios, model_name, processed, max_rephrasings, log,
                verb="scoring", note=""):
    """(scenario, rephrasing) pairs not yet in the workbook, scenario by
    scenario, each scenario's count logged."""
    todo_items: List[tuple] = []
    for scenario in scenarios:
        rephrasings = scenario["rephrasings"]
        if max_rephrasings:
            rephrasings = rephrasings[:max_rephrasings]
        todo = [
            r for r in rephrasings
            if (model_name, scenario["original_main"], r) not in processed
        ]
        if not todo:
            log(f"Scenario already complete for {model_name}")
            continue
        log(f"{model_name}: {verb} {len(todo)} rephrasings{note} of "
            f"scenario {scenario['original_main'][:50]!r}...")
        todo_items.extend((scenario, r) for r in todo)
    return todo_items


def run_model_perturbation_sweep(
    engine,
    model_name: str,
    scenarios: Sequence[Dict],
    output_xlsx: str,
    checkpoint_every: int = 100,
    max_rephrasings: Optional[int] = None,
    confidence: bool = True,
    confidence_max_new_tokens: int = 10,
    score_chunk: int = 2000,
    log: Optional[SessionLogger] = None,
    fuse_prefix: bool = True,
) -> List[Dict]:
    """Local-model perturbation sweep (the module docstring has the
    contract).  Returns every row of the workbook, resumed ones first, as
    dicts in ``PERTURBATION_COLUMNS`` order.

    ``fuse_prefix`` (engines with ``score_prefixed``): each rephrasing
    tokenizes once a chunk and prefills once a row; the binary and
    confidence legs run as pre-tokenized format-suffix extensions over the
    shared prefix cache.  Suffixes tokenize as ``" " + format`` without
    special tokens, the split spelling of the reference's
    ``f"{rephrasing} {format}"``.  With more than one chunk, a background
    thread tokenizes chunk N+1 while the device scores chunk N.  Engines
    without ``score_prefixed``, and ``fuse_prefix=False``, take the
    two-string route: each leg scores its full prompt string."""
    log = log or SessionLogger()
    if getattr(engine, "plan_decision", None):
        # the operating point was chosen by the plan search: name the
        # decision in the sweep log
        log(f"[plan] {engine.plan_decision}")
    all_rows, processed = load_existing_rows(output_xlsx)
    ckpt = _Checkpoint(output_xlsx, all_rows)
    # One scoring call mixes all scenarios' rephrasings (the engine takes
    # per-prompt target pairs), so the partial tail batches collapse to one
    # per bucket a chunk.  ``score_chunk`` rows score a call: it bounds the
    # loss of a crash, which loses the chunk in flight.
    todo_items = _todo_items(scenarios, model_name, processed,
                             max_rephrasings, log)

    # an engine whose score_prompts does not take max_new_tokens gets no
    # confidence cap (probed once)
    try:
        params = inspect.signature(engine.score_prompts).parameters
        takes_cap = ("max_new_tokens" in params
                     or any(p.kind == p.VAR_KEYWORD for p in params.values()))
    except (TypeError, ValueError):
        takes_cap = True

    fuse = fuse_prefix and callable(getattr(engine, "score_prefixed", None))

    # transient errors retry in place with backoff; OOM is the engine's
    # batch ladder's, and real errors propagate at once
    score_prompts = faults.retry_transient(
        engine.score_prompts, label="perturbation.score")
    first_token = faults.retry_transient(
        engine.first_token_relative_prob, label="perturbation.first_token")
    score_prefixed = (faults.retry_transient(
        engine.score_prefixed, label="perturbation.score_prefixed")
        if fuse else None)

    if fuse:
        # each scenario's format suffixes tokenize once a sweep
        tok = engine.tokenizer
        suffix_ids = []
        for s in scenarios:
            texts = [" " + s["response_format"]]
            if confidence:
                texts.append(" " + s["confidence_format"])
            suffix_ids.append([
                list(ids) for ids in
                tok(texts, add_special_tokens=False)["input_ids"]])
        scenario_slot = {id(s): i for i, s in enumerate(scenarios)}

        def encode_chunk(chunk):
            """One chunk's rephrasings tokenized once each, as
            pre-tokenized (prefix_ids, suffix_ids_per_leg) pairs; runs on
            the prefetcher's thread while the device scores the previous
            chunk."""
            prefix_ids = tok([r for _, r in chunk])["input_ids"]
            pairs = [
                (list(p), tuple(suffix_ids[scenario_slot[id(s)]]))
                for p, (s, _) in zip(prefix_ids, chunk)
            ]
            targets = [list(s["target_tokens"]) for s, _ in chunk]
            return chunk, pairs, targets

    def score_chunk_fused(chunk, pairs, targets):
        """One fused call scores both legs over the shared prefix cache;
        the confidence leg's generation stops at
        ``confidence_max_new_tokens`` (its first integer and the first
        three positions are all the parse reads)."""
        legs = [LegSpec("binary")]
        if confidence:
            legs.append(LegSpec(
                "confidence", with_confidence=True,
                max_new_tokens=confidence_max_new_tokens or None))
        outs = score_prefixed(pairs, targets=targets, legs=legs)
        return outs[0], (outs[1] if confidence else None)

    def score_chunk_legacy(chunk, targets):
        """The two-full-string route: each leg scores its full prompt."""
        binary_prompts = [f"{r} {s['response_format']}" for s, r in chunk]
        responses = score_prompts(binary_prompts, targets=targets)
        conf_rows = None
        if confidence:
            conf_prompts = [f"{r} {s['confidence_format']}"
                            for s, r in chunk]
            cap_kw = ({"max_new_tokens": confidence_max_new_tokens}
                      if confidence_max_new_tokens and takes_cap else {})
            conf_rows = score_prompts(
                conf_prompts, targets=targets, with_confidence=True,
                **cap_kw)
        return responses, conf_rows

    chunks = [todo_items[start:start + score_chunk]
              for start in range(0, len(todo_items), score_chunk)]
    prefetcher = None
    if fuse and len(chunks) > 1:
        prefetcher = HostPrefetcher(chunks, encode_chunk)
        chunk_iter = iter(prefetcher)
    elif fuse:
        chunk_iter = iter(map(encode_chunk, chunks))
    else:
        chunk_iter = iter((c, None, [list(s["target_tokens"]) for s, _ in c])
                          for c in chunks)

    counters_snap = counters()
    sweep_t0 = time.perf_counter()
    done_rows, total_rows = 0, len(todo_items)
    obs_flight.enable(os.path.dirname(os.path.abspath(output_xlsx)))
    watchdog = obs_flight.StallWatchdog(label=f"perturbation:{model_name}")
    # the guard flushes the pending rows on SIGTERM/SIGINT; _closing stops
    # the prefetcher's thread when an error leaves the loop
    with faults.PreemptionGuard(ckpt.flush, label="perturbation"), \
            _closing(prefetcher), watchdog:
        for start, (chunk, pairs, targets) in zip(
                range(0, len(todo_items), score_chunk), chunk_iter):
            if fuse:
                responses, conf_rows = score_chunk_fused(chunk, pairs,
                                                         targets)
            else:
                responses, conf_rows = score_chunk_legacy(chunk, targets)
            ecfg = getattr(engine, "ecfg", None)
            if (ecfg is not None
                    and getattr(ecfg, "first_token_top_filter", None) == TOP_LOGPROBS
                    and responses
                    and all("first_token_yes_prob" in row for row in responses)):
                # the scoring pass already read the top-20-filtered
                # position-0 probabilities from its own prefill logits
                probs = np.asarray([
                    [row["first_token_yes_prob"], row["first_token_no_prob"],
                     row["first_token_relative_prob"]] for row in responses
                ])
            else:   # another filter, a foreign engine or error rows
                binary_prompts = (
                    [list(p) + list(s[0]) for p, s in pairs] if fuse
                    else [f"{r} {s['response_format']}" for s, r in chunk])
                probs = first_token(
                    binary_prompts, targets=targets, top_filter=TOP_LOGPROBS
                )
            n_nan = int(np.isnan(np.asarray(probs[:, :2], dtype=float))
                        .any(axis=1).sum())
            if n_nan:
                # the rows are still written (the schema carries them and a
                # resume must not re-score them silently), and the event is
                # on record
                record_fault("nan_logits", model=model_name, rows=n_nan,
                             chunk_start=start)
                log(f"{model_name}: WARNING — {n_nan} rows carry NaN target "
                    f"probabilities (recorded in telemetry)")

            conf_values: List[Optional[int]] = [None] * len(chunk)
            conf_texts = [""] * len(chunk)
            weighted: List[Optional[float]] = [None] * len(chunk)
            if confidence:
                for i, row in enumerate(conf_rows):
                    conf_texts[i] = row["completion"]
                    conf_values[i] = extract_first_int(row["completion"])
                    weighted[i] = row.get("weighted_confidence")

            with obs.span("build_rows", phase="host_rows",
                          rows=len(chunk)):
                for i, (scenario, reph) in enumerate(chunk):
                    t1p, t2p = float(probs[i, 0]), float(probs[i, 1])
                    odds = t1p / t2p if t2p > 0 else float("inf")
                    ckpt.pending.append(
                        perturbation_row(
                            model_name,
                            scenario,
                            reph,
                            response_text=responses[i]["completion"],
                            confidence_text=conf_texts[i],
                            logprobs_repr=(
                                f"local:first_token_top{TOP_LOGPROBS}"),
                            token_1_prob=t1p,
                            token_2_prob=t2p,
                            odds_ratio=odds,
                            confidence_value=conf_values[i],
                            weighted_confidence=weighted[i],
                        )
                    )
                    processed.add((model_name, scenario["original_main"],
                                   reph))
                    if len(ckpt.pending) >= checkpoint_every:
                        ckpt.flush()
            # one code path prints the line, sets the gauges, writes the
            # JSONL metrics sample and beats the stall watchdog
            done_rows += len(chunk)
            obs_metrics.heartbeat(model_name, done_rows, total_rows,
                                  time.perf_counter() - sweep_t0, log=log)
        ckpt.flush(final=True)
    delta = counters_since(counters_snap)
    if delta.get("kv_cache_bytes_saved") or delta.get("prefill_chunks"):
        # the int8-KV / chunked-prefill operating point is on record per
        # sweep: a sweep that fell back to bf16 monolithic is another
        # measurement
        log(f"{model_name}: kv_cache_bytes_saved="
            f"{delta.get('kv_cache_bytes_saved', 0):.0f} "
            f"prefill_chunks={delta.get('prefill_chunks', 0):.0f}")
    return [{c: r.get(c) for c in PERTURBATION_COLUMNS} for r in all_rows]


def run_packed_perturbation_sweep(
    engine,
    model_name: str,
    scenarios: Sequence[Dict],
    output_xlsx: str,
    packing: int = 4,
    drift_parity: bool = True,
    checkpoint_every: int = 100,
    max_rephrasings: Optional[int] = None,
    score_chunk: int = 2000,
    log: Optional[SessionLogger] = None,
) -> Tuple[List[Dict], Optional[Dict]]:
    """Packed multi-question perturbation sweep: ``packing`` rephrasings
    join into one row (each followed by its demonstration answer), the row
    prefills once, and each question's binary-leg probabilities read from
    the logits at its answer anchor (``ScoringEngine.score_packed``): no
    decode and no confidence leg.

    ``drift_parity`` (the default) first scores the same rows isolated
    (``first_token_relative_prob`` under the top-20 filter), takes each
    question's isolated answer as its demonstration, and returns the drift
    block of packed against isolated (``scoring.packed.drift_report``) over
    the rows this call scored; without it the demonstrations are each
    scenario's yes target and the block is None.

    The workbook keeps the 15 columns: ``Model Response`` and the
    confidence columns are empty, and ``Log Probabilities`` names the
    packed extractor (``local:packed{Q}:first_token_top20``).  Side-log
    resume and the preemption flush are the unpacked sweep's.  Returns
    ``(rows, drift block or None)``, the rows as dicts in
    ``PERTURBATION_COLUMNS`` order."""
    if not callable(getattr(engine, "score_packed", None)):
        raise ValueError(
            "packed sweep needs an engine with score_packed (the anchor-"
            "gather prefill path); foreign engines score isolated only")
    log = log or SessionLogger()
    if getattr(engine, "plan_decision", None):
        log(f"[plan] {engine.plan_decision}")
    all_rows, processed = load_existing_rows(output_xlsx)
    ckpt = _Checkpoint(output_xlsx, all_rows)
    todo_items = _todo_items(scenarios, model_name, processed,
                             max_rephrasings, log, verb="packed-scoring",
                             note=f" (Q={packing})")

    score_packed = faults.retry_transient(
        engine.score_packed, label="perturbation.packed")
    first_token = faults.retry_transient(
        engine.first_token_relative_prob,
        label="perturbation.packed_isolated")

    sweep_t0 = time.perf_counter()
    done_rows, total_rows = 0, len(todo_items)
    drift_packed: List[float] = []
    drift_isolated: List[float] = []
    obs_flight.enable(os.path.dirname(os.path.abspath(output_xlsx)))
    watchdog = obs_flight.StallWatchdog(
        label=f"perturbation-packed:{model_name}")
    with faults.PreemptionGuard(ckpt.flush, label="perturbation-packed"), \
            watchdog:
        for start in range(0, len(todo_items), score_chunk):
            chunk = todo_items[start:start + score_chunk]
            prompts = [f"{r} {s['response_format']}" for s, r in chunk]
            targets = [list(s["target_tokens"]) for s, _ in chunk]
            iso = None
            if drift_parity:
                iso = first_token(prompts, targets=targets,
                                  top_filter=TOP_LOGPROBS)
                demos = packed_mod.demos_from_relative_probs(iso[:, 2],
                                                             targets)
            else:
                demos = [t[0] for t in targets]
            packs = packed_mod.build_packs(prompts, packing, demos)
            rows = score_packed(packs, targets=targets)
            if iso is not None:
                drift_isolated.extend(float(v) for v in iso[:, 2])
                # error rows carry no first_token_* fields: NaN puts them
                # in the drift block's n_skipped
                drift_packed.extend(
                    row.get("first_token_relative_prob", float("nan"))
                    for row in rows)
            n_err = sum(1 for row in rows if not row.get("success"))
            if n_err:
                record_fault("packed_error_rows", model=model_name,
                             rows=n_err, chunk_start=start)
                log(f"{model_name}: WARNING — {n_err} packed rows are "
                    f"error rows (recorded in telemetry)")
            with obs.span("build_rows", phase="host_rows",
                          rows=len(chunk)):
                for i, (scenario, reph) in enumerate(chunk):
                    t1p = rows[i].get("first_token_yes_prob", float("nan"))
                    t2p = rows[i].get("first_token_no_prob", float("nan"))
                    odds = t1p / t2p if t2p > 0 else float("inf")
                    ckpt.pending.append(
                        perturbation_row(
                            model_name, scenario, reph,
                            response_text="",
                            confidence_text="",
                            logprobs_repr=(f"local:packed{packing}:"
                                           f"first_token_top{TOP_LOGPROBS}"),
                            token_1_prob=t1p,
                            token_2_prob=t2p,
                            odds_ratio=odds,
                            confidence_value=None,
                            weighted_confidence=None,
                        )
                    )
                    processed.add((model_name, scenario["original_main"],
                                   reph))
                    if len(ckpt.pending) >= checkpoint_every:
                        ckpt.flush()
            done_rows += len(chunk)
            obs_metrics.heartbeat(f"{model_name}[packed{packing}]",
                                  done_rows, total_rows,
                                  time.perf_counter() - sweep_t0, log=log)
        ckpt.flush(final=True)
    report = None
    if drift_parity:
        report = packed_mod.drift_report(drift_packed, drift_isolated,
                                         packing)
        log(f"{model_name}: packed drift |Δrel_prob| mean "
            f"{report['mean_abs_delta']} p90 {report['p90_abs_delta']} "
            f"flip rate {report['flip_rate']} "
            f"({report['n_questions']} questions, Q={packing})")
    return ([{c: r.get(c) for c in PERTURBATION_COLUMNS} for r in all_rows],
            report)
