"""Base-vs-instruct MAE vs human means (paper Table 5).

Behavioral replica of survey_analysis/analyze_base_vs_instruct_mae_100q.py:
MODEL_FAMILIES map, data-quality gates (std < 0.01 or > 50% NaN excludes a
model), per-family MAE against the human mean, and a paired bootstrap (10k,
seed 42) of the instruct − base MAE difference with CI and two-sided p.

A copy of the JAX package's module on the results' row dicts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import frame

MODEL_FAMILIES = {
    "Falcon": {"base": "tiiuae/falcon-7b", "instruct": "tiiuae/falcon-7b-instruct"},
    "StableLM": {
        "base": "stabilityai/stablelm-base-alpha-7b",
        "instruct": "stabilityai/stablelm-tuned-alpha-7b",
    },
    "RedPajama": {
        "base": "togethercomputer/RedPajama-INCITE-7B-Base",
        "instruct": "togethercomputer/RedPajama-INCITE-7B-Instruct",
    },
    "BLOOM": {"base": "bigscience/bloom-7b1", "instruct": "bigscience/bloomz-7b1"},
    "Pythia-Dolly": {
        "base": "EleutherAI/pythia-6.9b",
        "instruct": "databricks/dolly-v2-7b",
    },
    "Mistral": {
        "base": "mistralai/Mistral-7B-v0.1",
        "instruct": "mistralai/Mistral-7B-Instruct-v0.2",
    },
}

MIN_STD_THRESHOLD = 0.01
MAX_NAN_FRACTION = 0.5
N_BOOTSTRAP = 10_000
RANDOM_SEED = 42


def validate_model_data(model_df: List[Dict], model_name: str) -> Tuple[bool, str]:
    """Quality gates: enough data, not mostly NaN, not constant."""
    data = [r["relative_prob"] for r in model_df if r["model"] == model_name]
    if len(data) == 0:
        return False, "No data found"
    nan_fraction = sum(frame.is_na(v) for v in data) / len(data)
    if nan_fraction > MAX_NAN_FRACTION:
        return False, f"{nan_fraction * 100:.0f}% NaN values"
    valid = frame.dropna(data)
    if len(valid) > 1 and frame.std(valid) < MIN_STD_THRESHOLD:
        return False, f"Constant values (std={frame.std(valid):.4f})"
    return True, "OK"


def mae_per_model(
    model_df: List[Dict],
    human_avgs: Dict[str, float],
    matches: Dict[str, str],
    model_name: str,
) -> Tuple[Optional[float], List[float], List[str]]:
    """(MAE, per-question |error| list, matched prompts) vs human means (0-1)."""
    sub = [r for r in model_df if r["model"] == model_name]
    errors, prompts = [], []
    for row in sub:
        prompt = row["prompt"]
        qid = matches.get(prompt)
        if qid is not None and qid in human_avgs:
            if not frame.is_na(row["relative_prob"]):
                errors.append(abs(float(row["relative_prob"]) - human_avgs[qid]))
                prompts.append(prompt)
    if errors:
        return float(np.mean(errors)), errors, prompts
    return None, [], []


def paired_bootstrap_mae_difference(
    base_errors: Sequence[float],
    instruct_errors: Sequence[float],
    n_bootstrap: int = N_BOOTSTRAP,
    seed: int = RANDOM_SEED,
) -> Dict:
    """Paired resampling of question indices; CI + two-sided p for
    instruct − base MAE."""
    base = np.asarray(base_errors, dtype=float)
    inst = np.asarray(instruct_errors, dtype=float)
    n = min(len(base), len(inst))
    base, inst = base[:n], inst[:n]
    observed = float(np.mean(inst) - np.mean(base))
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(n_bootstrap, n))
    diffs = np.mean(inst[idx], axis=1) - np.mean(base[idx], axis=1)
    if observed > 0:
        p = 2 * float(np.mean(diffs <= 0))
    else:
        p = 2 * float(np.mean(diffs >= 0))
    return {
        "observed_diff": observed,
        "base_mae": float(np.mean(base)),
        "instruct_mae": float(np.mean(inst)),
        "ci_lower": float(np.percentile(diffs, 2.5)),
        "ci_upper": float(np.percentile(diffs, 97.5)),
        "p_value": min(p, 1.0),
        "n": int(n),
    }


def analyze_families(
    model_df: List[Dict],
    human_avgs: Dict[str, float],
    matches: Dict[str, str],
    families: Optional[Dict] = None,
    n_bootstrap: int = N_BOOTSTRAP,
    seed: int = RANDOM_SEED,
) -> Dict[str, Dict]:
    """Per-family Table-5 records; pooled record under key '_overall'."""
    families = families or MODEL_FAMILIES
    results: Dict[str, Dict] = {}
    pooled_base: List[float] = []
    pooled_inst: List[float] = []
    for family, pair in families.items():
        rec: Dict = {"base_model": pair["base"], "instruct_model": pair["instruct"]}
        ok_b, why_b = validate_model_data(model_df, pair["base"])
        ok_i, why_i = validate_model_data(model_df, pair["instruct"])
        if not ok_b or not ok_i:
            rec["excluded"] = True
            rec["reason"] = f"base: {why_b}; instruct: {why_i}"
            results[family] = rec
            continue
        base_mae, base_err, base_prompts = mae_per_model(model_df, human_avgs, matches, pair["base"])
        inst_mae, inst_err, inst_prompts = mae_per_model(model_df, human_avgs, matches, pair["instruct"])
        if base_mae is None or inst_mae is None:
            rec["excluded"] = True
            rec["reason"] = "no matched questions"
            results[family] = rec
            continue
        # pair on common prompts for the paired bootstrap
        common = [p for p in base_prompts if p in set(inst_prompts)]
        b_map = dict(zip(base_prompts, base_err))
        i_map = dict(zip(inst_prompts, inst_err))
        base_paired = [b_map[p] for p in common]
        inst_paired = [i_map[p] for p in common]
        boot = paired_bootstrap_mae_difference(base_paired, inst_paired, n_bootstrap, seed)
        # boot's base/instruct MAE are over paired prompts only; keep the
        # all-prompt MAEs as the headline values (reference behavior)
        boot.pop("base_mae", None)
        boot.pop("instruct_mae", None)
        rec.update(excluded=False, base_mae=base_mae, instruct_mae=inst_mae, **boot)
        results[family] = rec
        pooled_base.extend(base_paired)
        pooled_inst.extend(inst_paired)
    if pooled_base:
        results["_overall"] = paired_bootstrap_mae_difference(
            pooled_base, pooled_inst, n_bootstrap, seed
        )
    return results
