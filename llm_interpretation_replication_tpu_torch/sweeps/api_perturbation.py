"""Frontier-API perturbation sweeps, the study's legs on vendor APIs (a
copy of the JAX package's ``sweeps/api_perturbation.py`` on lists of row
dicts in place of DataFrames: the same columns, order and resume keys).

- **OpenAI batch** (:func:`run_api_perturbation_sweep`): per scenario x
  rephrasing, the binary + confidence request pair; triples already in
  the workbook are skipped; the client's chunked batch lifecycle (50k a
  batch, 24h window, 60 s polling); first-token target probabilities and
  the int-token weighted confidence; the 15-column workbook appended per
  model.  Reasoning models (o*/gpt-5*) run the confidence leg only with
  ``skip_reasoning_logprobs`` (the default); otherwise the binary leg
  repeats ``REASONING_MODEL_RUNS`` times and probabilities are response
  frequencies.
- **Claude message batches** (:func:`run_claude_perturbation_sweep`):
  confidence only, at temperature 1.0, into the 16-column workbook.
- **GPT sync** (:func:`run_gpt_perturbation_sweep`) and **Gemini
  threaded** (:func:`run_gemini_perturbation_sweep`): binary + confidence
  per rephrasing with workbook checkpoints and resume.

Every leg returns the workbook's rows (``utils.xlsx.read_xlsx``), or
``[]`` when nothing was written.
"""


from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..api_backends.openai_client import build_batch_request, is_reasoning_model
from ..scoring.confidence import (
    extract_first_int,
    weighted_confidence_digits,
    weighted_confidence_single_tokens,
)
from ..utils.logging import SessionLogger
from ..utils.xlsx import append_xlsx, read_xlsx
from .writers import (
    CLAUDE_PERTURBATION_COLUMNS,
    PERTURBATION_COLUMNS,
    perturbation_row,
)

REASONING_MODEL_RUNS = 10  # binary repeats of a reasoning model


def _workbook_rows(output_xlsx: str) -> List[Dict]:
    import os

    return read_xlsx(output_xlsx)[1] if os.path.exists(output_xlsx) else []


def load_processed_triples(output_xlsx: str) -> Set[Tuple[str, str, str]]:
    """(Model, Original Main Part, Rephrased Main Part) triples already in the
    output workbook (the resume key)."""
    return {
        (str(r["Model"]), str(r["Original Main Part"]), str(r["Rephrased Main Part"]))
        for r in _workbook_rows(output_xlsx)
    }


def create_batch_requests(
    model: str,
    scenarios: Sequence[Dict],
    processed: Optional[Set[Tuple[str, str, str]]] = None,
    skip_reasoning_logprobs: bool = True,
    max_rephrasings: Optional[int] = None,
) -> Tuple[List[Dict], Dict[str, Dict]]:
    """Request list + custom_id -> prompt-info mapping.

    ``scenarios`` are perturbations.json records (original_main,
    response_format, target_tokens, confidence_format, rephrasings).
    """
    reasoning = is_reasoning_model(model)
    requests: List[Dict] = []
    id_mapping: Dict[str, Dict] = {}
    counter = 0
    for prompt_idx, scenario in enumerate(scenarios):
        rephrasings = scenario["rephrasings"]
        if max_rephrasings is not None:      # 0 means "none", not "all"
            rephrasings = rephrasings[:max_rephrasings]
        for rephrase_idx, rephrased in enumerate(rephrasings):
            if processed and (model, scenario["original_main"], rephrased) in processed:
                continue
            formats = (
                ["confidence"] if (reasoning and skip_reasoning_logprobs)
                else ["binary", "confidence"]
            )
            for format_type in formats:
                suffix = (scenario["response_format"] if format_type == "binary"
                          else scenario["confidence_format"])
                full_prompt = f"{rephrased} {suffix}"
                runs = (REASONING_MODEL_RUNS
                        if reasoning and format_type == "binary" else 1)
                for run_idx in range(runs):
                    custom_id = f"req-{counter}"
                    id_mapping[custom_id] = {
                        "prompt_idx": prompt_idx,
                        "rephrase_idx": rephrase_idx,
                        "format_type": format_type,
                        "run_idx": run_idx,
                        "original_main": scenario["original_main"],
                        "response_format": scenario["response_format"],
                        "confidence_format": scenario["confidence_format"],
                        "rephrased_main": rephrased,
                        "target_tokens": list(scenario["target_tokens"]),
                        "model": model,
                    }
                    requests.append(
                        build_batch_request(
                            custom_id, model,
                            [{"role": "user", "content": full_prompt}],
                        )
                    )
                    counter += 1
    return requests, id_mapping


def group_batch_results(raw_results: Sequence[Dict],
                        id_mapping: Dict[str, Dict]) -> Dict[Tuple[int, int], Dict]:
    """Re-pair downloaded JSONL rows into per-(prompt, rephrasing) groups:
    binary runs accumulate, confidence is singular."""
    grouped: Dict[Tuple[int, int], Dict] = {}
    for row in raw_results:
        info = id_mapping.get(row.get("custom_id"))
        if info is None:
            continue
        body = (row.get("response") or {}).get("body")
        if body is None or (row.get("error") is not None):
            continue
        key = (info["prompt_idx"], info["rephrase_idx"])
        slot = grouped.setdefault(
            key, {"mapping_info": info, "binary_results": [], "confidence_result": None}
        )
        if info["format_type"] == "binary":
            slot["binary_results"].append(body)
        else:
            slot["confidence_result"] = body
    return grouped


def extract_results_from_batch(
    grouped: Dict[Tuple[int, int], Dict],
    model: str,
    skip_reasoning_logprobs: bool = True,
    log=None,
) -> List[Dict]:
    """Batch bodies -> 15-column workbook rows."""
    reasoning = is_reasoning_model(model)
    rows: List[Dict] = []
    for key in sorted(grouped):
        slot = grouped[key]
        info = slot["mapping_info"]
        binary_results = slot["binary_results"]
        confidence_result = slot["confidence_result"]
        if not binary_results and not (reasoning and skip_reasoning_logprobs):
            if log:
                log(f"Warning: no binary results for {key}")
            continue
        if confidence_result is None:
            # half-failed pair: binary succeeded but confidence errored
            # (reasoning models in frequency mode included; skip-logprobs
            # mode only ever creates slots from confidence responses).
            # Writing the row would let triple-based resume skip it forever
            # with a null confidence: leave it out so resume retries, as the
            # Claude leg does for failed requests.
            if log:
                log(f"Warning: no confidence result for {key} — will retry on resume")
            continue

        # past the guards above, confidence_result is always present — a
        # null-confidence row is never a representable output
        response_body = None
        skip_mode = False
        weighted_confidence = None
        confidence_answer = confidence_result["choices"][0]["message"]["content"].strip()
        confidence_value = extract_first_int(confidence_answer)
        if reasoning and not skip_reasoning_logprobs:
            # frequency-based probability approximation over the runs
            t1 = t2 = 0
            texts = []
            for body in binary_results:
                text = body["choices"][0]["message"]["content"].strip()
                texts.append(text)
                if info["target_tokens"][0] in text:
                    t1 += 1
                elif info["target_tokens"][1] in text:
                    t2 += 1
            n = len(binary_results)
            token_1_prob = t1 / n if n else 0.0
            token_2_prob = t2 / n if n else 0.0
            answer_text = max(set(texts), key=texts.count) if texts else ""
            weighted_confidence = confidence_value
        elif reasoning:
            answer_text = "N/A (skipped for reasoning model)"
            token_1_prob = token_2_prob = 0.0
            skip_mode = True
            weighted_confidence = confidence_value
        else:
            response_body = binary_results[0]
            answer_text = response_body["choices"][0]["message"]["content"].strip()
            token_1_prob = token_2_prob = 0.0
            content = ((response_body["choices"][0].get("logprobs") or {})
                       .get("content") or [])
            if content:
                for cand in content[0].get("top_logprobs", []):
                    if cand["token"] == info["target_tokens"][0]:
                        token_1_prob = float(np.exp(cand["logprob"]))
                    elif cand["token"] == info["target_tokens"][1]:
                        token_2_prob = float(np.exp(cand["logprob"]))
            # logprob-weighted expected value over int tokens 0-100
            # across ALL positions (scoring/confidence's int scan)
            positions = [
                [(c["token"], c["logprob"])
                 for c in token_info.get("top_logprobs", [])]
                for token_info in ((confidence_result["choices"][0]
                                    .get("logprobs") or {}).get("content") or [])
            ]
            weighted_confidence = weighted_confidence_single_tokens(positions)

        # skip-logprobs rows record 0.0, not inf
        odds_ratio = (0.0 if skip_mode
                      else token_1_prob / token_2_prob if token_2_prob > 0
                      else float("inf"))
        rows.append({
            "Model": model,
            "Original Main Part": info["original_main"],
            "Response Format": info["response_format"],
            "Confidence Format": info["confidence_format"],
            "Rephrased Main Part": info["rephrased_main"],
            "Full Rephrased Prompt": f"{info['rephrased_main']} {info['response_format']}",
            "Full Confidence Prompt": f"{info['rephrased_main']} {info['confidence_format']}",
            "Model Response": answer_text,
            "Model Confidence Response": confidence_answer,
            "Log Probabilities": (
                "N/A for reasoning models" if reasoning
                else str((response_body or {}).get("choices", [{}])[0].get("logprobs", {}))
            ),
            "Token_1_Prob": token_1_prob,
            "Token_2_Prob": token_2_prob,
            "Odds_Ratio": odds_ratio,
            "Confidence Value": confidence_value,
            "Weighted Confidence": weighted_confidence,
        })
    return rows


def run_api_perturbation_sweep(
    client,
    models: Sequence[str],
    scenarios: Sequence[Dict],
    output_xlsx: str,
    max_workers: int = 3,
    poll_interval: float = 60.0,
    skip_reasoning_logprobs: bool = True,
    max_rephrasings: Optional[int] = None,
    cost_tracker=None,
    sleep=time.sleep,
    log: Optional[SessionLogger] = None,
) -> List[Dict]:
    """Fan ≤``max_workers`` models through the Batch API concurrently,
    appending each model's rows to ``output_xlsx`` as it finishes so a
    crash keeps completed models (resume skips their triples)."""
    log = log or SessionLogger()
    processed = load_processed_triples(output_xlsx)

    def run_model(model: str) -> List[Dict]:
        requests, id_mapping = create_batch_requests(
            model, scenarios, processed=processed,
            skip_reasoning_logprobs=skip_reasoning_logprobs,
            max_rephrasings=max_rephrasings,
        )
        if not requests:
            log(f"{model}: nothing to do (all triples processed)")
            return []
        log(f"{model}: submitting {len(requests)} batch requests")
        raw = client.run_batch(requests, poll_interval=poll_interval, sleep=sleep)
        if cost_tracker is not None:
            for row in raw:
                usage = ((row.get("response") or {}).get("body") or {}).get("usage")
                if usage:
                    cost_tracker.record(
                        model,
                        usage.get("prompt_tokens", 0),
                        usage.get("completion_tokens", 0),
                    )
        grouped = group_batch_results(raw, id_mapping)
        return extract_results_from_batch(
            grouped, model, skip_reasoning_logprobs=skip_reasoning_logprobs, log=log
        )

    failures: List[Tuple[str, Exception]] = []
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        futures = {pool.submit(run_model, model): model for model in models}
        for future in as_completed(futures):
            model = futures[future]
            try:                 # one failed batch must not lose the others
                rows = future.result()
            # graftlint: disable=G05 reference :929-946 per-model guard: one failed API batch logs and the other vendors' batches continue
            except Exception as err:
                log(f"{model}: FAILED — {err}")
                failures.append((model, err))
                continue
            if rows:
                append_xlsx(PERTURBATION_COLUMNS, rows, output_xlsx)
                log(f"{model}: appended {len(rows)} rows to {output_xlsx}")
    if failures and len(failures) == len(models):
        raise RuntimeError(f"every model failed: {failures}")
    return _workbook_rows(output_xlsx)


# ---------------------------------------------------------------------------
# Claude Message-Batches leg
# ---------------------------------------------------------------------------
#
# Claude exposes no logprobs, so the batch sweep runs CONFIDENCE-ONLY at
# temperature 1.0; binary fields carry the study's literal N/A sentinels
# and zeroed probabilities.

def create_claude_batch_requests(
    model: str,
    scenarios: Sequence[Dict],
    processed: Optional[Set[Tuple[str, str]]] = None,
    max_rephrasings: Optional[int] = None,
) -> Tuple[List[Dict], Dict[str, Dict]]:
    """Confidence-only request list + id map; ``processed`` holds
    (original_main, rephrased_main) pairs already in the workbook."""
    from ..api_backends.anthropic_client import build_batch_request

    requests: List[Dict] = []
    id_mapping: Dict[str, Dict] = {}
    counter = 0
    for prompt_idx, scenario in enumerate(scenarios):
        rephrasings = scenario["rephrasings"]
        if max_rephrasings is not None:
            rephrasings = rephrasings[:max_rephrasings]
        for rephrase_idx, rephrased in enumerate(rephrasings):
            if processed and (scenario["original_main"], rephrased) in processed:
                continue
            custom_id = f"confidence-{counter}"
            id_mapping[custom_id] = {
                "prompt_idx": prompt_idx,
                "rephrase_idx": rephrase_idx,
                "original_main": scenario["original_main"],
                "response_format": scenario["response_format"],
                "confidence_format": scenario["confidence_format"],
                "rephrased_main": rephrased,
                "target_tokens": list(scenario["target_tokens"]),
            }
            requests.append(build_batch_request(
                custom_id, model,
                [{"role": "user",
                  "content": f"{rephrased} {scenario['confidence_format']}"}],
                temperature=1.0,
            ))
            counter += 1
    return requests, id_mapping


def extract_claude_batch_rows(raw_results: Sequence[Dict], id_mapping: Dict[str, Dict],
                              model: str, log=None) -> List[Dict]:
    """Batch result JSONL -> the 16-column Claude workbook rows (with the
    extra 'Target Tokens' column)."""
    rows: List[Dict] = []
    for row in raw_results:
        info = id_mapping.get(row.get("custom_id"))
        if info is None:
            continue
        result = row.get("result") or {}
        if result.get("type") != "succeeded":
            # leave errored/expired pairs OUT of the workbook so resume
            # retries them (the OpenAI leg's semantics; an empty row would
            # be skipped by resume forever)
            if log:
                log(f"Warning: failed request {row.get('custom_id')} — will retry on resume")
            continue
        content = (result.get("message") or {}).get("content") or []
        text = (content[0].get("text", "") if content else "").strip()
        confidence = extract_first_int(text)
        rows.append({
            "Model": model,
            "Original Main Part": info["original_main"],
            "Response Format": info["response_format"],
            "Confidence Format": info["confidence_format"],
            "Rephrased Main Part": info["rephrased_main"],
            "Target Tokens": str(info["target_tokens"]),
            "Model Confidence Response": text,
            "Full Confidence Prompt": f"{info['rephrased_main']} {info['confidence_format']}",
            "Confidence Value": confidence,
            "Weighted Confidence": confidence,
            "Model Response": "N/A (Confidence-only mode)",
            "Full Rephrased Prompt": "N/A (Confidence-only mode)",
            "Log Probabilities": "N/A (Batch processing - logprobs not available)",
            "Token_1_Prob": 0.0,
            "Token_2_Prob": 0.0,
            "Odds_Ratio": 0.0,
        })
    return rows


def run_claude_perturbation_sweep(
    client,
    model: str,
    scenarios: Sequence[Dict],
    output_xlsx: str,
    poll_interval: float = 30.0,
    max_rephrasings: Optional[int] = None,
    sleep=time.sleep,
    log: Optional[SessionLogger] = None,
) -> List[Dict]:
    """Submit-or-resume the confidence-only Claude batch sweep and append the
    16-column workbook (10k-request chunks handled by
    ``client.run_batches``)."""
    log = log or SessionLogger()
    # resume per model: another model's rows in the same workbook must not
    # mask this one
    processed = {
        (orig, reph)
        for m, orig, reph in load_processed_triples(output_xlsx)
        if m == model
    }
    requests, id_mapping = create_claude_batch_requests(
        model, scenarios, processed=processed, max_rephrasings=max_rephrasings
    )
    if requests:
        log(f"{model}: submitting {len(requests)} message-batch requests")
        raw = client.run_batches(requests, poll_interval=poll_interval, sleep=sleep)
        rows = extract_claude_batch_rows(raw, id_mapping, model, log=log)
        if rows:
            append_xlsx(CLAUDE_PERTURBATION_COLUMNS, rows, output_xlsx)
            log(f"{model}: appended {len(rows)} rows to {output_xlsx}")
    else:
        log(f"{model}: nothing to do (all pairs processed)")
    return _workbook_rows(output_xlsx)


# ---------------------------------------------------------------------------
# GPT sync leg
# ---------------------------------------------------------------------------
#
# The non-batch OpenAI sweep: one binary + one confidence chat completion
# per rephrasing, prompts joined with a BLANK LINE ("{rephrasing}\n\n
# {format}", unlike the Gemini leg's single space), a first-token top-20
# logprob scan for the target tokens, the single-token weighted
# confidence, a 0.5 s rate-limit sleep between pairs, max_tokens=10 on
# both calls, and the checkpoint-append + resume-by-(model, original,
# rephrased) discipline of the Claude/Gemini legs.  Token_i_Prob records
# the first-position probabilities of the target tokens, and 'Log
# Probabilities' the BINARY response's top-20 first-position logprobs
# they are derived from.

def _gpt_perturbation_row(client, model: str, scenario: Dict,
                          rephrased: str) -> Dict:
    import json as jsonlib
    import math

    from ..api_backends.evaluators import openai_content_and_logprobs

    binary_prompt = f"{rephrased}\n\n{scenario['response_format']}"
    confidence_prompt = f"{rephrased}\n\n{scenario['confidence_format']}"
    t1, t2 = scenario["target_tokens"][0], scenario["target_tokens"][1]

    binary = client.chat_completion(
        model, [{"role": "user", "content": binary_prompt}],
        max_tokens=10)
    text, content = openai_content_and_logprobs(binary)
    p1 = p2 = 0.0
    top0 = content[0].get("top_logprobs", []) if content else []
    for item in top0:
        tok = (item.get("token") or "").strip()
        if tok == t1:
            p1 = math.exp(item["logprob"])
        elif tok == t2:
            p2 = math.exp(item["logprob"])

    conf = client.chat_completion(
        model, [{"role": "user", "content": confidence_prompt}],
        max_tokens=10)
    conf_text, conf_content = openai_content_and_logprobs(conf)
    positions = [
        [(i["token"], i["logprob"]) for i in tok.get("top_logprobs", [])]
        for tok in conf_content
    ]
    return perturbation_row(
        model, scenario, rephrased,
        response_text=text,
        confidence_text=conf_text,
        logprobs_repr=jsonlib.dumps(
            [{"token": i.get("token"), "logprob": i.get("logprob")}
             for i in top0]),
        token_1_prob=p1,
        token_2_prob=p2,
        odds_ratio=p1 / p2 if p2 > 0 else float("inf"),
        confidence_value=extract_first_int(conf_text),
        weighted_confidence=weighted_confidence_single_tokens(positions),
    )


def run_gpt_perturbation_sweep(
    client,
    model: str,
    scenarios: Sequence[Dict],
    output_xlsx: str,
    checkpoint_every: int = 50,
    rate_limit_sleep: float = 0.5,
    max_rephrasings: Optional[int] = None,
    sleep=time.sleep,
    log: Optional[SessionLogger] = None,
) -> List[Dict]:
    """Serial checkpointed GPT sync sweep: a per-rephrasing loop with a
    workbook append every ``checkpoint_every`` rows and resume by (model,
    original, rephrased) triple, in the 15-column schema shared with the
    OpenAI-batch and Gemini legs."""
    if is_reasoning_model(model):
        # o*/gpt-5* return no logprobs, so every row would record
        # Token_i_Prob=0; the batch pipeline has the reasoning-model modes
        # (confidence-only / frequency repeats): route there instead.
        raise ValueError(
            f"{model} is a reasoning model (no logprobs on the sync API); "
            f"use run-api-perturbation, whose batch pipeline handles "
            f"reasoning models")
    log = log or SessionLogger()
    processed = load_processed_triples(output_xlsx)
    work: List[Tuple[Dict, str]] = []
    for scenario in scenarios:
        rephrasings = scenario["rephrasings"]
        if max_rephrasings is not None:
            rephrasings = rephrasings[:max_rephrasings]
        for rephrased in rephrasings:
            if (model, scenario["original_main"], rephrased) not in processed:
                work.append((scenario, rephrased))
    if not work:
        log(f"{model}: nothing to do (all triples processed)")
    else:
        log(f"{model}: evaluating {len(work)} perturbations (sync)")
        pending: List[Dict] = []
        errors = 0
        for scenario, rephrased in work:
            try:
                pending.append(
                    _gpt_perturbation_row(client, model, scenario, rephrased))
            # graftlint: disable=G05 API-side failure: count it, log it, keep the paid sweep alive (no device errors flow here)
            except Exception as err:
                errors += 1
                log(f"{model}: evaluation failed — {err}")
            if len(pending) >= checkpoint_every:
                append_xlsx(PERTURBATION_COLUMNS, pending, output_xlsx)
                log(f"{model}: checkpointed {len(pending)} rows")
                pending.clear()
            if rate_limit_sleep:
                sleep(rate_limit_sleep)
        if pending:
            append_xlsx(PERTURBATION_COLUMNS, pending, output_xlsx)
            log(f"{model}: checkpointed {len(pending)} rows")
        if errors:
            log(f"{model}: {errors} evaluations failed (will retry on resume)")
            if errors == len(work):
                raise RuntimeError(
                    f"{model}: every evaluation failed ({errors}/{len(work)})"
                )
    return _workbook_rows(output_xlsx)


# ---------------------------------------------------------------------------
# Gemini sync/threaded leg
# ---------------------------------------------------------------------------
#
# Gemini's sync API returns logprobs (responseLogprobs=True, top 19), so the
# sweep evaluates binary + confidence per rephrasing directly: first-position
# target-token probabilities, multi-token digit reconstruction for weighted
# confidence, a 20-thread fan-out behind the client's token-bucket rate
# limiter, and a workbook checkpoint every ``checkpoint_every`` completions.

def _gemini_perturbation_row(client, model: str, scenario: Dict,
                             rephrased: str) -> Dict:
    import math

    binary_prompt = f"{rephrased} {scenario['response_format']}"
    confidence_prompt = f"{rephrased} {scenario['confidence_format']}"
    t1, t2 = scenario["target_tokens"][0], scenario["target_tokens"][1]

    binary = client.generate_content(model, binary_prompt, response_logprobs=True)
    positions = client.top_candidates_of(binary)
    p1 = p2 = 0.0
    if positions:
        for token, logprob in positions[0]:
            if token.strip() == t1:
                p1 = math.exp(logprob)
            elif token.strip() == t2:
                p2 = math.exp(logprob)

    conf = client.generate_content(model, confidence_prompt, response_logprobs=True)
    conf_text = client.text_of(conf)
    return perturbation_row(
        model, scenario, rephrased,
        response_text=client.text_of(binary),
        confidence_text=conf_text,
        logprobs_repr=str(positions[:3]),
        token_1_prob=p1,
        token_2_prob=p2,
        odds_ratio=p1 / p2 if p2 > 0 else float("inf"),
        confidence_value=extract_first_int(conf_text),
        weighted_confidence=weighted_confidence_digits(client.top_candidates_of(conf)),
    )


def run_gemini_perturbation_sweep(
    client,
    model: str,
    scenarios: Sequence[Dict],
    output_xlsx: str,
    max_workers: int = 20,
    checkpoint_every: int = 50,
    max_rephrasings: Optional[int] = None,
    log: Optional[SessionLogger] = None,
) -> List[Dict]:
    """Threaded sync sweep with incremental workbook checkpoints and
    (model, original, rephrased) resume, in the 15-column schema shared
    with the OpenAI leg."""
    import threading

    log = log or SessionLogger()
    processed = load_processed_triples(output_xlsx)
    work: List[Tuple[Dict, str]] = []
    for scenario in scenarios:
        rephrasings = scenario["rephrasings"]
        if max_rephrasings is not None:
            rephrasings = rephrasings[:max_rephrasings]
        for rephrased in rephrasings:
            if (model, scenario["original_main"], rephrased) not in processed:
                work.append((scenario, rephrased))
    if not work:
        log(f"{model}: nothing to do (all triples processed)")
    else:
        log(f"{model}: evaluating {len(work)} perturbations on {max_workers} threads")
        pending: List[Dict] = []
        lock = threading.Lock()

        def flush_locked():
            if pending:
                append_xlsx(PERTURBATION_COLUMNS, pending, output_xlsx)
                log(f"{model}: checkpointed {len(pending)} rows")
                pending.clear()

        def flush_with_lock():
            with lock:
                flush_locked()

        def flush_for_preemption():
            # Signal handlers run in the MAIN thread.  A blocking acquire
            # on a lock the main thread itself holds (the final
            # flush_with_lock below) would deadlock inside the preemption
            # grace window.  The bounded wait covers worker-held locks
            # (short appends); if the main thread is already mid-flush,
            # those rows are being written anyway — skip.
            if lock.acquire(timeout=5.0):
                try:
                    flush_locked()
                finally:
                    lock.release()

        def run_one(item):
            scenario, rephrased = item
            row = _gemini_perturbation_row(client, model, scenario, rephrased)
            with lock:
                pending.append(row)
                if len(pending) >= checkpoint_every:
                    flush_locked()

        # Preemption safety (runtime/faults.py): a SIGTERM/SIGINT in the
        # main thread checkpoints the completed-but-unflushed rows before
        # exit; the resumed sweep's triple-keyed skip set redoes only the
        # in-flight evaluations.
        from ..runtime.faults import PreemptionGuard

        errors = 0
        with PreemptionGuard(flush_for_preemption, label="gemini_perturbation"):
            pool = ThreadPoolExecutor(max_workers=max_workers)
            try:
                futures = [pool.submit(run_one, item) for item in work]
                for future in as_completed(futures):
                    try:
                        future.result()
                    # graftlint: disable=G05 API-side failure: count it, log it, keep the paid sweep alive (no device errors flow here)
                    except Exception as err:
                        errors += 1
                        log(f"{model}: evaluation failed — {err}")
            except BaseException:
                # preemption/Ctrl-C: drop the queued work instead of the
                # context manager's shutdown(wait=True) — the grace window
                # cannot absorb thousands of queued API calls.  Only the
                # <= max_workers in-flight calls finish (joined by the
                # executor's atexit hook); their rows re-run on resume.
                pool.shutdown(wait=False, cancel_futures=True)
                raise
            pool.shutdown(wait=True)
            flush_with_lock()
        if errors:
            log(f"{model}: {errors} evaluations failed (will retry on resume)")
            if errors == len(work):
                raise RuntimeError(
                    f"{model}: every evaluation failed ({errors}/{len(work)})"
                )
    return _workbook_rows(output_xlsx)
