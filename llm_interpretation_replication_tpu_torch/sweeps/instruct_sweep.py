"""The instruct-model sweep and the base-vs-instruct word-meaning sweep (a
copy of ``sweeps/instruct_sweep.py``).

``run_instruct_sweep`` scores the questions with each model of the
10-model instruct roster and writes ``instruct_model_comparison_results.csv``;
``run_base_vs_instruct_word_meaning`` scores them with each base and
instruct model of the word-meaning pairs and writes
``model_comparison_results.csv``.  Both checkpoint after every model (a
SIGTERM or SIGINT saves the completed models first), so a preempted run
resumes, and both return the CSV's rows as dicts rather than a DataFrame;
the CSV holds the bytes the reference's ``DataFrame.to_csv`` writes.
"""

from __future__ import annotations

import hashlib
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..config import instruct_sweep_models, model_pairs_word_meaning
from ..runtime import faults
from ..scoring.prompts import format_prompt
from ..utils.checkpoint import CheckpointFile
from ..utils.logging import SessionLogger, heartbeat
from .writers import (INSTRUCT_COMPARISON_COLUMNS, MODEL_COMPARISON_COLUMNS,
                      instruct_comparison_frame, model_comparison_frame,
                      write_csv)

EngineFactory = Callable[[str], object]  # model name -> ScoringEngine


def _score_model(engine, model_name: str, prompts: Sequence[str],
                 is_base: bool) -> Dict[str, Dict]:
    """One model's rows keyed by question.  Transient errors retry with
    backoff (``faults.default_transient_policy``) before any other error
    turns every row of the model into a ``MODEL_ERROR`` row."""
    formatted = [format_prompt(q, is_base, model_name) for q in prompts]
    try:
        rows = faults.retry_transient(
            engine.score_prompts, label=f"instruct.{model_name}")(formatted)
    except Exception as err:
        rows = [
            {
                "yes_prob": float("nan"), "no_prob": float("nan"),
                "relative_prob": float("nan"), "odds_ratio": float("nan"),
                "completion": f"MODEL_ERROR: {str(err)[:50]}", "success": False,
            }
            for _ in prompts
        ]
    return {q: row for q, row in zip(prompts, rows)}


def _prompts_fingerprint(prompts: Sequence[str]) -> str:
    digest = hashlib.sha256("\n".join(prompts).encode("utf-8")).hexdigest()
    return f"{len(prompts)}:{digest[:16]}"


def run_instruct_sweep(
    engine_factory: EngineFactory,
    prompts: Sequence[str],
    models: Optional[Sequence[str]] = None,
    checkpoint_path: str = "results/instruct_sweep_checkpoint.json",
    results_csv: str = "results/instruct_model_comparison_results.csv",
) -> List[Dict]:
    """Score ``prompts`` with each model of ``models`` (default: the
    10-model roster), skipping the models the checkpoint holds, and write
    the CSV.  A checkpoint of another question list (its fingerprint
    differs) starts fresh.  The sweep drops its reference to a model's
    engine once its rows are in, so a factory that makes a new engine
    each call frees the weights before the next model loads."""
    log = SessionLogger()
    models = list(models if models is not None else instruct_sweep_models())
    fp = _prompts_fingerprint(prompts)
    ck = CheckpointFile(checkpoint_path, default={"outputs": {}, "prompts": fp})
    state = ck.load()
    if state.get("prompts", fp) != fp:
        log(f"Checkpoint {checkpoint_path} belongs to a different prompt set "
            f"({state.get('prompts')} != {fp}); starting fresh")
        state = {"outputs": {}, "prompts": fp}
    state["prompts"] = fp
    outputs: Dict[str, Dict] = state["outputs"]
    sweep_t0 = time.perf_counter()
    scored = 0
    # outputs gains a model only once its rows are in, so a SIGTERM flush
    # saves completed models only
    with faults.PreemptionGuard(
            lambda: ck.save({"outputs": outputs, "prompts": fp}),
            label="instruct_sweep"):
        for model_name in models:
            if model_name in outputs:
                log(f"Skipping {model_name} (checkpointed)")
                continue
            log(f"Running instruct model: {model_name}")
            engine = engine_factory(model_name)
            outputs[model_name] = _score_model(engine, model_name, prompts,
                                               is_base=False)
            del engine          # its weights go before the next model loads
            ck.save({"outputs": outputs, "prompts": fp})
            scored += 1
            remaining = sum(1 for m in models if m not in outputs)
            elapsed = time.perf_counter() - sweep_t0
            rate = scored * len(prompts) / elapsed if elapsed > 0 else 0.0
            heartbeat("instruct_sweep", len(outputs), len(models), elapsed,
                      log, unit="models", rate=rate, rate_unit="rows",
                      eta_s=(remaining * len(prompts) / rate) if rate > 0
                      else 0.0)
    rows = instruct_comparison_frame(outputs, models)
    write_csv(INSTRUCT_COMPARISON_COLUMNS, rows, results_csv)
    log(f"Saved {len(rows)} rows to {results_csv}")
    return rows


def run_base_vs_instruct_word_meaning(
    engine_factory: EngineFactory,
    prompts: Sequence[str],
    model_pairs: Optional[Sequence[Dict]] = None,
    checkpoint_path: str = "results/model_comparison_checkpoint.json",
    results_csv: str = "results/model_comparison_results.csv",
) -> List[Dict]:
    """Score ``prompts`` with the base model (few-shot prompts) and the
    instruct model (bare prompts) of each pair of ``model_pairs`` (default:
    the word-meaning pairs), skipping checkpointed models, and write the
    CSV."""
    log = SessionLogger()
    model_pairs = list(model_pairs if model_pairs is not None
                       else model_pairs_word_meaning())
    pair_tuples = [(p["base"], p["instruct"]) for p in model_pairs]
    ck = CheckpointFile(checkpoint_path, default={"outputs": {}})
    state = ck.load()
    outputs: Dict[str, Dict] = state["outputs"]
    with faults.PreemptionGuard(lambda: ck.save({"outputs": outputs}),
                                label="base_vs_instruct_word_meaning"):
        for base, instruct in pair_tuples:
            for model_name, is_base in ((base, True), (instruct, False)):
                if model_name in outputs:
                    log(f"Skipping {model_name} (checkpointed)")
                    continue
                log(f"Running {'base' if is_base else 'instruct'} model: "
                    f"{model_name}")
                engine = engine_factory(model_name)
                outputs[model_name] = _score_model(engine, model_name,
                                                   prompts, is_base)
                del engine
                ck.save({"outputs": outputs})
    rows = model_comparison_frame(outputs, pair_tuples)
    write_csv(MODEL_COMPARISON_COLUMNS, rows, results_csv)
    log(f"Saved {len(rows)} rows to {results_csv}")
    return rows
