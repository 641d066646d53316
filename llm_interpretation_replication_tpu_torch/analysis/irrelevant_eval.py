"""Irrelevant-perturbation evaluation (3,400 insertions × 3 frontier models).

Rebuild of evaluate_irrelevant_perturbations.py:372-1297: evaluate the
original + every perturbed scenario (response leg + confidence leg per
triple, temperature 0.7) with ``extract_final_number`` parsing for
thinking-model outputs, resume via a processed-triple checkpoint + JSON
progress heartbeat, per-scenario/model consistency + confidence statistics,
violin plots, and Excel/CSV/JSON outputs.  Vendor clients are injected
(evaluator callables ``(prompt) -> reply text``) so local models and tests
plug in the same way.

A copy of the JAX package's module on row dicts and ``utils.frame`` in place
of pandas: a result table is a list of dicts (``RESULT_COLUMNS``), typed as
``pd.DataFrame`` types them; groups run in pandas' sorted group-key order.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..scoring.confidence import extract_final_number
from ..utils import frame
from ..utils.checkpoint import ProcessedSet
from ..utils.logging import Progress, SessionLogger
from ..utils.strict_json import nan_to_null as _nan_to_null
from ..utils.xlsx import write_xlsx, write_xlsx_sheets

Evaluator = Callable[[str], str]  # perturbed scenario text -> model reply text

RESULT_COLUMNS = [
    "model", "scenario_name", "perturbation_id", "irrelevant_statement",
    "position_index", "position_description", "response", "confidence",
    "confidence_raw_response", "is_original", "response_prompt",
    "confidence_prompt",
]

SUMMARY_COLUMNS = [
    "scenario", "model", "consistency", "original_confidence",
    "mean_all_confidence", "std_all_confidence", "median_all_confidence",
    "ci_lower_95", "ci_upper_95", "n_samples", "mean_perturbed_confidence",
    "std_perturbed_confidence", "original_response", "num_perturbations",
    "num_total_samples",
]

DELAY_BETWEEN_REQUESTS = 0.1  # reference :62


def build_vendor_evaluators(
    gpt_client=None,
    claude_client=None,
    gemini_client=None,
    models: Optional[Dict[str, Dict]] = None,
    sleep: Optional[Callable[[float], None]] = None,
    delay: float = DELAY_BETWEEN_REQUESTS,
) -> Dict[str, Evaluator]:
    """``{"gpt"|"claude"|"gemini": prompt -> reply text}`` over the vendor
    clients, with each vendor's quirks preserved:

    - GPT: plain chat completion, no logprobs (reference :295-314)
    - Claude: create_message at the study temperature (:316-334)
    - Gemini: safety thresholds BLOCK_NONE and ``max_output_tokens``
      deliberately UNSET — setting it triggered empty-reply truncation on
      gemini-2.5-pro (:336-369 and the client's own bug-dodge note)

    Only vendors whose client is provided get an evaluator.  ``models``
    defaults to the study roster asset (temperature 0.7, 500-token replies,
    reference :41-57).  ``sleep`` adds the reference's inter-request pacing
    (:62); omit it in tests.
    """
    from ..config import irrelevant_eval_models

    models = models or irrelevant_eval_models()
    evaluators: Dict[str, Evaluator] = {}

    def paced(fn: Evaluator) -> Evaluator:
        if sleep is None:
            return fn

        def wrapped(prompt: str) -> str:
            out = fn(prompt)
            sleep(delay)
            return out

        return wrapped

    # each vendor's spec is bound as a default argument: a shared closure
    # variable would be rebound to the LAST vendor's spec by the time the
    # evaluators run, sending e.g. the Gemini model name to OpenAI
    if gpt_client is not None:

        def eval_gpt(prompt: str, spec=models["gpt"]) -> str:
            resp = gpt_client.chat_completion(
                spec["name"], [{"role": "user", "content": prompt}],
                temperature=spec["temperature"], max_tokens=spec["max_tokens"],
                logprobs=False,
            )
            return resp["choices"][0]["message"]["content"].strip()

        evaluators["gpt"] = paced(eval_gpt)
    if claude_client is not None:

        def eval_claude(prompt: str, spec=models["claude"]) -> str:
            msg = claude_client.create_message(
                spec["name"], [{"role": "user", "content": prompt}],
                max_tokens=spec["max_tokens"], temperature=spec["temperature"],
            )
            return claude_client.text_of(msg)

        evaluators["claude"] = paced(eval_claude)
    if gemini_client is not None:

        def eval_gemini(prompt: str, spec=models["gemini"]) -> str:
            resp = gemini_client.generate_content(
                spec["name"], prompt, temperature=spec["temperature"],
            )
            return gemini_client.text_of(resp)

        evaluators["gemini"] = paced(eval_gemini)
    return evaluators


def response_prompt(scenario: Dict, text: str) -> str:
    """``{text}\n\n{response_format}`` (evaluate_irrelevant_perturbations
    :407, :470)."""
    return f"{text}\n\n{scenario['response_format']}"


def confidence_prompt(scenario: Dict, text: str) -> str:
    return f"{text}\n\n{scenario['confidence_format']}"


def process_scenario_perturbations(
    evaluators: Dict[str, Evaluator],
    scenarios: Sequence[Dict],
    output_dir: str,
    include_original: bool = True,
    max_per_scenario: Optional[int] = None,
    limit_per_model: Optional[Dict[str, int]] = None,
    log: Optional[SessionLogger] = None,
) -> List[Dict]:
    """Evaluate every (model, scenario, perturbation) triple with resume;
    returns the result rows (``RESULT_COLUMNS``).

    ``limit_per_model`` caps NEW evaluations per model for this run (the
    reference's test-mode distribution, evaluate_irrelevant_perturbations.py
    :1138-1146, 1188-1223); already-processed triples don't count against it,
    and a scenario may be cut mid-way to honor the cap exactly."""
    log = log or SessionLogger()
    os.makedirs(output_dir, exist_ok=True)
    processed = ProcessedSet(os.path.join(output_dir, "processed_triples.json"))
    rows_path = os.path.join(output_dir, "raw_results.csv")
    if os.path.exists(rows_path):
        columns, rows = frame.read_csv(rows_path)
        if "response_text" in columns and "response" not in columns:
            # pre-rename checkpoint: the old single-leg sweep stored only the
            # confidence reply.  Keep it under its new name; the response leg
            # for those rows is genuinely absent (NaN), which
            # consistency_statistics excludes rather than counting as
            # disagreement.
            rows = [{("confidence_raw_response" if k == "response_text" else k): v
                     for k, v in r.items()} for r in rows]
        # Seed the processed-set from the loaded rows: a kill between the
        # rows-CSV rename and the processed-set flush would otherwise make
        # run_one re-evaluate (and re-append) the last scenario's triples,
        # double-counting them in every downstream statistic.  Numeric pids
        # round-trip through the mixed-type CSV column as strings — restore
        # them so the keys match run_one's int pids.
        for r in rows:
            pid = r["perturbation_id"]
            if isinstance(pid, str) and pid.isdigit():
                pid = int(pid)
            elif isinstance(pid, float):
                pid = int(pid)
            processed.add((r["model"], r["scenario_name"], pid), flush=False)
    else:
        rows = []
    total = sum(
        (len(s["perturbations_with_irrelevant"][:max_per_scenario])
         if max_per_scenario else len(s["perturbations_with_irrelevant"]))
        + (1 if include_original else 0)
        for s in scenarios
    ) * len(evaluators)
    progress = Progress(total, path=os.path.join(output_dir, "progress.json"))

    def run_one(model: str, evaluate: Evaluator, scenario: Dict, pid, text: str, extra: Dict) -> bool:
        key = (model, scenario["scenario_name"], pid)
        if key in processed:
            return False
        # two legs per triple, like the reference: the yes/no-style response
        # prompt, then the 0-100 confidence prompt (:407-470).  Each leg
        # fails independently so a broken confidence call can't clobber a
        # good response (and vice versa); the sweep continues either way.
        r_prompt = response_prompt(scenario, text)
        c_prompt = confidence_prompt(scenario, text)
        try:
            response = evaluate(r_prompt)
        except Exception as err:
            response = f"ERROR: {str(err)[:100]}"
        try:
            reply = evaluate(c_prompt)
            confidence = extract_final_number(reply)
        except Exception as err:
            reply, confidence = f"ERROR: {str(err)[:100]}", None
        rows.append(
            {
                "model": model,
                "scenario_name": scenario["scenario_name"],
                "perturbation_id": pid,
                "response": str(response)[:500],
                "confidence": confidence,
                "confidence_raw_response": str(reply)[:500],
                "is_original": pid == "original",
                "response_prompt": r_prompt,
                "confidence_prompt": c_prompt,
                **extra,
            }
        )
        processed.add(key, flush=False)
        progress.update(1, model=model, scenario=scenario["scenario_name"])
        return True

    for model, evaluate in evaluators.items():
        budget = (limit_per_model or {}).get(model, float("inf"))
        for scenario in scenarios:
            if budget <= 0:
                log(f"{model}: reached evaluation limit, moving on")
                break
            perturbations = scenario["perturbations_with_irrelevant"]
            if max_per_scenario:
                perturbations = perturbations[:max_per_scenario]
            if include_original:
                budget -= run_one(
                    model, evaluate, scenario, "original", scenario["original_main"],
                    {"irrelevant_statement": "", "position_index": -1,
                     "position_description": "original"})
            for p in perturbations:
                if budget <= 0:
                    break
                budget -= run_one(
                    model, evaluate, scenario, p["perturbation_id"], p["perturbed_text"],
                    {
                        "irrelevant_statement": p["irrelevant_statement"],
                        "position_index": p["position_index"],
                        "position_description": p["position_description"],
                    },
                )
            # Rows first (atomic rename), processed-set second: a kill in
            # between re-evaluates at most one scenario on resume instead of
            # permanently dropping paid evaluations marked done but unsaved.
            tmp = rows_path + ".tmp"
            frame.write_csv(*frame.records(rows), tmp)
            os.replace(tmp, rows_path)
            processed.flush()
            log(f"{model} / {scenario['scenario_name']}: checkpointed ({len(rows)} rows)")
    rows = frame.records(rows, RESULT_COLUMNS)[1]
    frame.write_csv(RESULT_COLUMNS, rows, rows_path)
    return rows


# -- statistics on row dicts ------------------------------------------------------

def _usable(values: Sequence) -> List:
    """Responses that are present and not a one-leg ERROR sentinel (run_one
    records those to keep the sweep alive)."""
    return [v for v in frame.dropna(values) if not str(v).startswith("ERROR:")]


def _confidences(rows: Sequence[Dict]) -> np.ndarray:
    """``pd.to_numeric(rows["confidence"], errors="coerce").dropna()``."""
    return np.asarray(frame.dropna(frame.to_numeric(
        [r["confidence"] for r in rows])), dtype=float)


def _mode(values: Sequence):
    """``Series.mode().iloc[0]``: the smallest of the most frequent values,
    or None when there are none."""
    counts = frame.value_counts(values)
    if not counts:
        return None
    top = counts[0][1]
    return sorted(v for v, c in counts if c == top)[0]


def _groups(rows: Sequence[Dict]):
    """``df.groupby(["model", "scenario_name"])``: (key, rows) in sorted
    key order, NA keys dropped."""
    groups: Dict = {}
    for r in rows:
        key = (r["model"], r["scenario_name"])
        if frame.is_na(key[0]) or frame.is_na(key[1]):
            continue
        groups.setdefault(key, []).append(r)
    return sorted(groups.items(), key=lambda kv: kv[0])


def _split(sub: Sequence[Dict]):
    pert = [r for r in sub if r["perturbation_id"] != "original"]
    orig = [r for r in sub if r["perturbation_id"] == "original"]
    return pert, orig


def _original_reference(orig: Sequence[Dict], pert: Sequence[Dict]):
    """(original_response, original_confidence) with the reference's missing-
    original fallback — modal perturbed response + mean perturbed confidence
    (evaluate_irrelevant_perturbations.py:522-542)."""
    orig_resp, orig_conf = None, np.nan
    if len(orig):
        orig_conf = frame.to_numeric([r["confidence"] for r in orig])[0]
        orig_usable = _usable([r["response"] for r in orig])
        if len(orig_usable):
            orig_resp = orig_usable[0]
    if orig_resp is None and len(pert):
        orig_resp = _mode(_usable([r["response"] for r in pert]))
        if frame.is_na(orig_conf):
            vals_pert = _confidences(pert)
            orig_conf = float(vals_pert.mean()) if vals_pert.size else np.nan
    return orig_resp, orig_conf


def _agreement(responses: Sequence, orig_resp) -> float:
    return float(np.mean([v == orig_resp for v in responses]))


def _consistency(pert: Sequence[Dict], orig_resp) -> float:
    """Share of usable perturbed responses equal to the original's.  No
    perturbations at all -> trivially consistent (reference :565);
    perturbations exist but none measurable -> NaN, not a fabricated
    perfect score."""
    pert_resp = _usable([r["response"] for r in pert])
    if len(pert_resp) and orig_resp is not None:
        return _agreement(pert_resp, orig_resp)
    if len(pert) == 0:
        return 1.0
    return float("nan")


def _float_or_nan(v) -> float:
    return float(v) if not frame.is_na(v) else np.nan


def consistency_statistics(rows: Sequence[Dict]) -> List[Dict]:
    """Per (model, scenario) consistency + confidence statistics, matching
    evaluate_irrelevant_perturbations.analyze_results (:503-618) exactly:
    response consistency vs the original, pooled original+perturbed
    confidence stats (ddof=1 std, 2.5/97.5 percentiles), and the
    perturbed-only leg; plus the ``ci_width`` convenience column.  Rows are
    typed as ``pd.DataFrame(records)`` types them."""
    records = []
    for (model, scenario), sub in _groups(rows):
        pert, orig = _split(sub)
        vals_all = _confidences(sub)
        vals_pert = _confidences(pert)
        orig_resp, orig_conf = _original_reference(orig, pert)
        # rows whose response leg is missing or errored (legacy checkpoints,
        # one-leg failures) are excluded from the consistency denominator
        # instead of silently counting as disagreement.
        consistency = _consistency(pert, orig_resp)
        rec = {
            "model": model,
            "scenario_name": scenario,
            "consistency": consistency,
            "original_confidence": _float_or_nan(orig_conf),
            "original_response": orig_resp,
            "num_perturbations": int(len(pert)),
            "num_total_samples": int(len(sub)),
            "n_samples": int(vals_all.size),
        }
        if vals_all.size:
            p = np.percentile(vals_all, [2.5, 97.5])
            rec.update(
                mean_all_confidence=float(vals_all.mean()),
                std_all_confidence=frame.std(vals_all),
                median_all_confidence=float(frame.median(vals_all)),
                ci_lower_95=float(p[0]), ci_upper_95=float(p[1]),
                ci_width=float(p[1] - p[0]),
            )
        if vals_pert.size:
            rec.update(
                mean_perturbed_confidence=float(vals_pert.mean()),
                std_perturbed_confidence=frame.std(vals_pert),
            )
        records.append(rec)
    return frame.records(records)[1]


def analyze_results(rows: Sequence[Dict]) -> Dict:
    """Nested ``{scenario: {model: {...}}}`` analysis — the reference's
    ``analysis.json`` shape (evaluate_irrelevant_perturbations.py:503-618):
    consistency, confidence_stats (pooled + perturbed-only), per-position
    consistency, the original's prompts/raw reply, and the raw confidence
    values the violin plots draw from."""
    analysis: Dict = {}
    for (model, scenario), sub in _groups(rows):
        pert, orig = _split(sub)
        vals_all = _confidences(sub)
        vals_pert = _confidences(pert)
        if vals_all.size == 0:
            continue                       # reference :556: nothing to analyze
        orig_resp, orig_conf = _original_reference(orig, pert)

        confidence_stats = {
            "original_confidence": (float(orig_conf)
                                    if not frame.is_na(orig_conf) else None),
            "mean_all_confidence": float(vals_all.mean()),
            "std_all_confidence": frame.std(vals_all),
            "median_all_confidence": float(frame.median(vals_all)),
            "ci_lower_95": float(np.percentile(vals_all, 2.5)),
            "ci_upper_95": float(np.percentile(vals_all, 97.5)),
            "min_confidence": float(vals_all.min()),
            "max_confidence": float(vals_all.max()),
            "n_samples": int(vals_all.size),
        }
        if vals_pert.size:
            confidence_stats.update(
                mean_perturbed_confidence=float(vals_pert.mean()),
                std_perturbed_confidence=frame.std(vals_pert),
                median_perturbed_confidence=float(frame.median(vals_pert)),
                perturbed_ci_lower_95=float(np.percentile(vals_pert, 2.5)),
                perturbed_ci_upper_95=float(np.percentile(vals_pert, 97.5)),
            )

        position_consistency = {}
        if len(pert) and orig_resp is not None:
            for pos_idx in frame.unique(frame.dropna(
                    [r["position_index"] for r in pert])):
                pos = [r for r in pert if r["position_index"] == pos_idx]
                desc = pos[0]["position_description"] if len(pos) else str(pos_idx)
                pos_resp = _usable([r["response"] for r in pos])
                if len(pos_resp):
                    position_consistency[f"{int(pos_idx)}_{desc}"] = \
                        _agreement(pos_resp, orig_resp)

        def _orig_field(col: str) -> str:
            if len(orig) and col in orig[0] and not frame.is_na(orig[0][col]):
                return str(orig[0][col])
            return "N/A - Original missing"

        analysis.setdefault(scenario, {})[model] = {
            "consistency": _consistency(pert, orig_resp),
            "confidence_stats": confidence_stats,
            "position_consistency": position_consistency,
            "num_perturbations": int(len(pert)),
            "num_total_samples": int(len(sub)),
            "original_response": orig_resp,
            "original_response_prompt": _orig_field("response_prompt"),
            "original_confidence_prompt": _orig_field("confidence_prompt"),
            "original_confidence_raw_response": _orig_field("confidence_raw_response"),
            "confidence_values": [float(v) for v in vals_all],
        }
    return analysis


def summary_frame(analysis: Dict) -> List[Dict]:
    """The reference's ``summary.csv`` row set (:640-656), typed as
    ``pd.DataFrame(records)`` types it."""
    records = []
    for scenario, per_model in analysis.items():
        for model, a in per_model.items():
            cs = a["confidence_stats"]
            records.append({
                "scenario": scenario,
                "model": model,
                "consistency": a["consistency"],
                "original_confidence": cs.get("original_confidence"),
                "mean_all_confidence": cs.get("mean_all_confidence"),
                "std_all_confidence": cs.get("std_all_confidence"),
                "median_all_confidence": cs.get("median_all_confidence"),
                "ci_lower_95": cs.get("ci_lower_95"),
                "ci_upper_95": cs.get("ci_upper_95"),
                "n_samples": cs.get("n_samples"),
                "mean_perturbed_confidence": cs.get("mean_perturbed_confidence"),
                "std_perturbed_confidence": cs.get("std_perturbed_confidence"),
                "original_response": a["original_response"],
                "num_perturbations": a.get("num_perturbations", 0),
                "num_total_samples": a.get("num_total_samples", 0),
            })
    return frame.records(records, SUMMARY_COLUMNS if records else [])[1]


def position_frame(analysis: Dict) -> List[Dict]:
    """Long-form per-position consistency (the Position Analysis sheet's
    source, :663-673)."""
    return [
        {"scenario": scenario, "model": model, "position": position,
         "consistency": consistency}
        for scenario, per_model in analysis.items()
        for model, a in per_model.items()
        for position, consistency in a["position_consistency"].items()
    ]


def _position_sheet(positions: Sequence[Dict]):
    """``positions.pivot_table(index=["scenario", "model"],
    columns="position", values="consistency").reset_index()`` as
    ``(columns, rows)``: one row per (scenario, model) in sorted order, one
    column per position in sorted order (a position holds one value a
    pair, so its mean is that value; NaN where a pair has none)."""
    cells: Dict = {}
    for r in positions:
        cells.setdefault((r["scenario"], r["model"]), {})[r["position"]] = \
            r["consistency"]
    labels = sorted({r["position"] for r in positions})
    rows = [{"scenario": scenario, "model": model,
             **{label: cells[scenario, model].get(label, np.nan)
                for label in labels}}
            for scenario, model in sorted(cells)]
    return ["scenario", "model", *labels], rows


MODEL_DISPLAY_NAMES = {  # reference :848-853
    "gpt": "GPT-4.1", "claude": "Claude Opus 4.1", "gemini": "Gemini 2.5 Pro",
}


def create_stacked_visualization(analysis: Dict, output_dir: str) -> Optional[str]:
    """``three_model_stacked_visualization.png`` — vertically stacked violin
    panels, one per model in gpt/claude/gemini order (:803-941)."""
    scenarios = sorted(analysis)
    present = [m for m in MODEL_DISPLAY_NAMES
               if any(m in analysis[s] for s in scenarios)]
    if not present:
        return None
    from ..viz import figures

    values = {
        MODEL_DISPLAY_NAMES[m]: {
            s: analysis[s][m]["confidence_values"]
            for s in scenarios if m in analysis[s]
        }
        for m in present
    }
    return figures.stacked_violin_panels(
        values, os.path.join(output_dir, "three_model_stacked_visualization.png"),
        group_order=scenarios,
    )


def summary_report_text(analysis: Dict) -> str:
    """The human-readable ``summary_report.txt`` (:726-765)."""
    lines = ["IRRELEVANT STATEMENT PERTURBATION ANALYSIS", "=" * 60, ""]
    for scenario, per_model in analysis.items():
        lines += ["", scenario, "-" * 40]
        for model, a in per_model.items():
            cs = a["confidence_stats"]
            lines += [
                "", f"{model}:",
                f"  Consistency: {a['consistency']:.2%}",
                f"  Original Response: {a['original_response']}",
                f"  Number of Samples: {cs.get('n_samples', 'N/A')}",
                "", "  Confidence Statistics:",
                "    Original: "
                f"{'N/A' if cs.get('original_confidence') is None else cs['original_confidence']}",
                f"    Mean (all): {cs.get('mean_all_confidence', 0):.1f}",
                f"    Std Dev (all): {cs.get('std_all_confidence', 0):.1f}",
                f"    Median (all): {cs.get('median_all_confidence', 0):.1f}",
                f"    95% CI: [{cs.get('ci_lower_95', 0):.1f}, "
                f"{cs.get('ci_upper_95', 0):.1f}]",
            ]
            if "mean_perturbed_confidence" in cs:
                lines += [
                    f"    Mean (perturbed only): {cs['mean_perturbed_confidence']:.1f}",
                    f"    Std Dev (perturbed only): {cs['std_perturbed_confidence']:.1f}",
                ]
            lines.append("\n  Position Consistency:")
            for position, consistency in a["position_consistency"].items():
                lines.append(f"    {position}: {consistency:.2%}")
    return "\n".join(lines) + "\n"


def detailed_prompts_text(rows: Sequence[Dict], per_scenario: int = 5) -> str:
    """``detailed_prompts.txt`` — first few full prompt/response examples per
    scenario (:767-800)."""
    lines = ["DETAILED PROMPTS USED IN EVALUATION", "=" * 60, ""]
    counts: Dict[str, int] = {}
    seen = set()
    for row in rows:
        key = (row["scenario_name"], row["perturbation_id"])
        if key in seen:
            continue
        seen.add(key)
        n = counts.get(row["scenario_name"], 0)
        if n >= per_scenario:
            continue
        counts[row["scenario_name"]] = n + 1
        lines += [
            "", f"Scenario: {row['scenario_name']}",
            f"Perturbation ID: {row['perturbation_id']}",
        ]
        # original rows reloaded from a resume CSV carry NaN (truthy!) here
        if not frame.is_na(row.get("irrelevant_statement")) and \
                row.get("irrelevant_statement"):
            lines.append(f"Irrelevant Statement: {row['irrelevant_statement']}")

        def text(col):
            # NaN-guarded like irrelevant_statement above: rows resumed from
            # pre-prompt-column checkpoints reindex to NaN, not missing
            val = row.get(col, "")
            return "" if frame.is_na(val) else str(val)

        lines += [
            f"Model: {row['model']}", "-" * 40,
            "", "RESPONSE PROMPT:", text("response_prompt"),
            "", "CONFIDENCE PROMPT:", text("confidence_prompt"),
            "", f"Model Response: {row['response']}",
            f"Model Confidence: {row['confidence']}",
            f"Raw Confidence Response: {row['confidence_raw_response']}",
            "=" * 60,
        ]
        if counts[row["scenario_name"]] == per_scenario:
            lines.append(
                f"\n[Showing first {per_scenario} perturbations for "
                f"{row['scenario_name']}. Full data in raw_results.csv]"
            )
    return "\n".join(lines) + "\n"


def save_results(rows: Sequence[Dict], analysis: Dict, output_dir: str,
                 make_figures: bool = True) -> Dict[str, str]:
    """The reference's full artifact set (:620-800): raw_results.csv,
    summary.csv, the three-sheet results_analysis.xlsx, analysis.json,
    summary_report.txt, detailed_prompts.txt, and the stacked violin
    visualization."""
    os.makedirs(output_dir, exist_ok=True)
    summary = summary_frame(analysis)
    positions = position_frame(analysis)
    paths = {
        "csv": os.path.join(output_dir, "raw_results.csv"),
        "summary_csv": os.path.join(output_dir, "summary.csv"),
        "xlsx": os.path.join(output_dir, "results_analysis.xlsx"),
        "analysis_json": os.path.join(output_dir, "analysis.json"),
        "report": os.path.join(output_dir, "summary_report.txt"),
        "prompts": os.path.join(output_dir, "detailed_prompts.txt"),
    }
    frame.write_csv(RESULT_COLUMNS, rows, paths["csv"])
    frame.write_csv(SUMMARY_COLUMNS if summary else [], summary,
                    paths["summary_csv"])
    sheets = {"Raw Results": (RESULT_COLUMNS, rows),
              "Summary": (SUMMARY_COLUMNS, summary)}
    if len(positions):
        sheets["Position Analysis"] = _position_sheet(positions)
    write_xlsx_sheets(sheets, paths["xlsx"])
    with open(paths["analysis_json"], "w", encoding="utf-8") as f:
        # strict JSON: NaN/inf stats (all-error groups, single-sample std)
        # become null, not bare NaN tokens that non-Python consumers reject
        json.dump(_nan_to_null(analysis), f, indent=2, default=float)
    with open(paths["report"], "w", encoding="utf-8") as f:
        f.write(summary_report_text(analysis))
    with open(paths["prompts"], "w", encoding="utf-8") as f:
        f.write(detailed_prompts_text(rows))
    if make_figures:
        fig = create_stacked_visualization(analysis, output_dir)
        if fig:
            paths["figure"] = fig
    return paths


def run_irrelevant_evaluation(
    evaluators: Dict[str, Evaluator],
    scenarios: Sequence[Dict],
    output_dir: str,
    limit_total: Optional[int] = None,
    make_figures: bool = True,
    log: Optional[SessionLogger] = None,
) -> Dict[str, str]:
    """End-to-end study leg: evaluate (with resume), analyze, save everything.

    ``limit_total`` is the reference's test-mode budget, split evenly across
    the models with the remainder going to the first ones (:1138-1146)."""
    log = log or SessionLogger()
    limit_per_model = None
    if limit_total is not None:
        n = len(evaluators)
        per, rem = divmod(limit_total, n)
        limit_per_model = {
            m: per + (1 if i < rem else 0) for i, m in enumerate(evaluators)
        }
        log(f"test mode: {limit_total} evaluations split as {limit_per_model}")
    rows = process_scenario_perturbations(
        evaluators, scenarios, output_dir,
        limit_per_model=limit_per_model, log=log,
    )
    analysis = analyze_results(rows)
    return save_results(rows, analysis, output_dir, make_figures=make_figures)


def write_outputs(rows: Sequence[Dict], stats: Sequence[Dict], output_dir: str,
                  make_figures: bool = True) -> Dict[str, str]:
    """The raw rows (CSV and workbook), the consistency statistics (CSV and
    JSON) and one confidence violin per model."""
    os.makedirs(output_dir, exist_ok=True)
    paths = {
        "csv": os.path.join(output_dir, "raw_results.csv"),
        "xlsx": os.path.join(output_dir, "results.xlsx"),
        "stats_csv": os.path.join(output_dir, "consistency_stats.csv"),
        "stats_json": os.path.join(output_dir, "consistency_stats.json"),
    }
    frame.write_csv(RESULT_COLUMNS, rows, paths["csv"])
    write_xlsx(RESULT_COLUMNS, rows, paths["xlsx"])
    stat_columns = frame.records(stats)[0]
    frame.write_csv(stat_columns, stats, paths["stats_csv"])
    with open(paths["stats_json"], "w") as f:
        json.dump([dict(r) for r in stats], f, indent=2, default=float)
    if make_figures:
        from ..viz import figures

        for model in frame.unique([r["model"] for r in rows]):
            sub = [r for r in rows if r["model"] == model
                   and r["perturbation_id"] != "original"]
            groups: Dict = {}
            for r in sub:
                if not frame.is_na(r["scenario_name"]):
                    groups.setdefault(r["scenario_name"], []).append(r)
            groups = {scenario: _confidences(g).tolist()
                      for scenario, g in sorted(groups.items())}
            path = figures.violin_by_group(
                groups, f"{model} — confidence across irrelevant insertions",
                os.path.join(output_dir, f"violin_{str(model).replace('/', '--')}.png"),
            )
            if path:
                paths[f"violin_{model}"] = path
    return paths
