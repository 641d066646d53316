"""The 100-question base-vs-instruct sweep (a copy of
``sweeps/base_vs_instruct_100q.py``).

For each (base, instruct, family) pair, the 100 ordinary-meaning questions
are formatted (few-shot for the base model, bare for the instruct one) and
scored by that model's engine; the sweep checkpoints after every model, so
a preempted run resumes, and writes ``base_vs_instruct_100q_results.csv``.
Rows are returned as dicts in ``BASE_VS_INSTRUCT_100Q_COLUMNS`` order
rather than as a DataFrame; the CSV holds the bytes the reference's
``DataFrame.to_csv`` writes.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from ..config import model_pairs_100q, ordinary_meaning_questions
from ..runtime import faults
from ..scoring.prompts import format_prompt, format_prompt_parts
from ..utils.checkpoint import CheckpointFile
from ..utils.logging import SessionLogger
from .writers import BASE_VS_INSTRUCT_100Q_COLUMNS, write_csv

EngineFactory = Callable[[str], object]  # model name -> ScoringEngine


def run_model_on_prompts(engine, model_name: str, prompts: Sequence[str],
                         is_base_model: bool) -> List[Dict]:
    """One model's rows.  An engine with ``score_prefixed`` gets ``(prefix,
    suffix)`` pairs (the shared few-shot preamble tokenizes once and each
    question rides as a suffix extension over its prefix cache); the joined
    parts are the formatted prompt byte for byte.  Transient errors retry
    with backoff (``faults.default_transient_policy``); any other error
    turns every row of the model into an error row and the sweep moves
    on."""
    formatted = [format_prompt(q, is_base_model, model_name) for q in prompts]
    if callable(getattr(engine, "score_prefixed", None)):
        scored = [tuple(format_prompt_parts(q, is_base_model, model_name))
                  for q in prompts]
    else:
        scored = formatted
    try:
        rows = faults.retry_transient(
            engine.score_prompts, label=f"100q.{model_name}")(scored)
    except Exception as err:
        return [
            {
                "prompt": q,
                "model": model_name,
                "formatted_prompt": f[:200],
                "yes_prob": float("nan"),
                "no_prob": float("nan"),
                "relative_prob": float("nan"),
                "completion": f"MODEL_ERROR: {str(err)[:50]}",
                "success": False,
            }
            for q, f in zip(prompts, formatted)
        ]
    out = []
    for q, f, row in zip(prompts, formatted, rows):
        out.append(
            {
                "yes_prob": row["yes_prob"],
                "no_prob": row["no_prob"],
                "relative_prob": row["relative_prob"],
                "completion": row["completion"],
                "success": row["success"],
                "prompt": q,
                "model": model_name,
                "formatted_prompt": f[:200],
            }
        )
    return out


def run_sweep(
    engine_factory: EngineFactory,
    model_pairs: Optional[Sequence[Dict]] = None,
    prompts: Optional[Sequence[str]] = None,
    checkpoint_path: str = "results/base_vs_instruct_100q_checkpoint.json",
    results_csv: str = "results/base_vs_instruct_100q_results.csv",
) -> List[Dict]:
    """Score every model of ``model_pairs`` (default: the study's 6 pairs)
    on ``prompts`` (default: the 100 questions), skipping the models the
    checkpoint lists as completed, and write the CSV.  The sweep drops its
    reference to a model's engine once its rows are in, so a factory that
    makes a new engine each call frees the weights before the next model
    loads.  The checkpoint holds rows only of
    completed models, also when a SIGTERM lands between a model's rows and
    its completion mark: the resumed run then scores that model again."""
    log = SessionLogger()
    model_pairs = model_pairs if model_pairs is not None else model_pairs_100q()
    prompts = prompts if prompts is not None else ordinary_meaning_questions()
    ck = CheckpointFile(checkpoint_path, default={"completed_models": [], "results": []})
    state = ck.load()
    completed = set(state["completed_models"])
    all_results: List[Dict] = list(state["results"])

    def save_checkpoint():
        done = [r for r in all_results if r.get("model") in completed]
        ck.save({"completed_models": sorted(completed), "results": done})

    with faults.PreemptionGuard(save_checkpoint, label="100q_sweep"):
        for pair in model_pairs:
            base, instruct, family = pair["base"], pair["instruct"], pair["family"]
            for model_name, role, is_base in ((base, "base", True), (instruct, "instruct", False)):
                if model_name in completed:
                    log(f"Skipping {model_name} (already completed)")
                    continue
                log(f"Running {role.upper()} model: {model_name}")
                engine = engine_factory(model_name)
                results = run_model_on_prompts(engine, model_name, prompts,
                                               is_base)
                del engine          # its weights go before the next model loads
                for r in results:
                    r["model_family"] = family
                    r["base_or_instruct"] = role
                all_results.extend(results)
                completed.add(model_name)
                save_checkpoint()
                log(f"Checkpoint saved after {model_name}")

    rows = [{c: r[c] for c in BASE_VS_INSTRUCT_100Q_COLUMNS} for r in all_results]
    write_csv(BASE_VS_INSTRUCT_100Q_COLUMNS, rows, results_csv)
    log(f"Saved {len(rows)} rows to {results_csv}")
    return rows
