"""The port's ``viz`` (LaTeX tables and matplotlib figures) against the
JAX package's on the same seeded inputs: every LaTeX string equal, every
figure's PNG byte for byte (matplotlib's Agg PNG writer stamps no date;
both modules draw through one pyplot, so each pair is drawn from the same
state)."""

import numpy as np
import pytest

from llm_interpretation_replication_tpu.viz import figures as jfigures
from llm_interpretation_replication_tpu.viz import latex as jlatex
from llm_interpretation_replication_tpu_torch.viz import latex as tlatex
from test_torch_slots import one_torch_thread  # noqa: F401

RNG_SEED = 11


def values(n=80, seed=RNG_SEED):
    rng = np.random.default_rng(seed)
    v = np.clip(rng.normal(0.55, 0.3, n), 0, 1)
    v[::17] = np.nan
    return v


class Frame:
    """Just ``iterrows()``: what the compliance tables read of a frame."""

    def __init__(self, rows):
        self.rows = rows

    def iterrows(self):
        return enumerate(self.rows)


# -- LaTeX -------------------------------------------------------------------------

def latex_cases():
    rng = np.random.default_rng(RNG_SEED)
    compliance = Frame([
        {"Prompt": i, "Total_Samples": 100 + i,
         "First_Token_Compliance_Rate": float(rng.uniform(0, 100)),
         "First_Token_Non_Compliance_Rate": float(rng.uniform(0, 100)),
         "Conditional_Subsequent_Compliance_Rate":
             None if i == 1 else (float("nan") if i == 2
                                  else float(rng.uniform(0, 100)))}
        for i in range(1, 5)])
    confidence = Frame([
        {"Prompt": i, "Total_Confidence_Samples": 50 * i,
         "Confidence_Compliance_Rate": float(rng.uniform(0, 100)),
         "Float_Errors": i, "Text_Errors": 2 * i, "Out_Of_Range_Errors": 0}
        for i in range(1, 4)])
    mae = {"GPT_4.1": {"mae": 0.2051, "ci_lower": 0.18, "ci_upper": 0.23},
           "Claude & co": {"mae": 0.25, "ci_lower": 0.2, "ci_upper": 0.3}}
    diffs = {"GPT_4.1": {"always_50": {"diff": 0.032, "ci_lower": -0.01,
                                       "ci_upper": 0.08, "p_value": 0.004},
                         "normal#1": {"diff": -0.1, "ci_lower": -0.2,
                                      "ci_upper": 0.0, "p_value": 0.07}}}
    families = {"_meta": {}, "falcon": {"excluded": True, "reason": "no_pairs"},
                "mistral": {"base_mae": 0.3, "instruct_mae": 0.2,
                            "observed_diff": -0.1, "ci_lower": -0.15,
                            "ci_upper": -0.05, "p_value": 0.001}}
    report = {"models": {
        "GPT": {"effect_size": 0.254, "achieved_power": 0.4213,
                "sample_sizes": {"power_80": {"raw": 122, "with_margin": 183},
                                 "power_90": {"raw": 163, "with_margin": 245}}},
        "Zero": {"effect_size": 0.0, "achieved_power": 0.05,
                 "sample_sizes": {"power_80": {"raw": np.inf,
                                               "with_margin": np.inf},
                                  "power_90": {"raw": np.inf,
                                               "with_margin": np.inf}}}},
        "recommendation": {"power_80": {"raw": 122, "with_margin": 183,
                                        "limiting_model": "GPT"}}}
    infinite = dict(report, recommendation={"power_80": {
        "raw": np.inf, "with_margin": np.inf, "limiting_model": "Zero_1"}})
    statements = [f"Fact {i}: 25°C × π − 3% of $5 #{i} ⁻¹⁹ H₂O m² m³ – end"
                  for i in range(40)]
    return {
        "summary": ("summary_stats_table", (values(), "scen_1", "Scenario 1"),
                    {}),
        "summary_empty": ("summary_stats_table",
                          ([np.nan, np.inf], "empty", "None"), {}),
        "standalone": ("standalone_document", (["T1", "T2"],),
                       {"title": "A & B_c"}),
        "compliance": ("compliance_table", (compliance,), {}),
        "confidence": ("confidence_compliance_table", (confidence,), {}),
        "mae": ("mae_results_tables", (mae,), {}),
        "mae_diffs": ("mae_results_tables", (mae, diffs), {}),
        "stars": ("significance_stars", (0.049,), {}),
        "base_vs_instruct": ("base_vs_instruct_table", (families,), {}),
        "escape": ("escape_statement", (statements[3],), {}),
        "statements": ("irrelevant_statements_sample", (statements,),
                       {"k": 12, "seed": 7}),
        "power": ("power_analysis_table", (report,),
                  {"alpha": 0.05, "sample_size": 50}),
        "power_infinite": ("power_analysis_table", (infinite,),
                           {"alpha": 0.01, "sample_size": 20}),
    }


@pytest.mark.parametrize("case", sorted(latex_cases()))
def test_latex_strings_equal(case):
    name, args, kwargs = latex_cases()[case]
    got = getattr(tlatex, name)(*args, **kwargs)
    assert got == getattr(jlatex, name)(*args, **kwargs)
    assert isinstance(got, str)


def test_significance_stars_bands():
    for p in (None, float("nan"), 0.001, 0.01, 0.03, 0.05, 0.07, 0.1, 0.5):
        assert tlatex.significance_stars(p) == jlatex.significance_stars(p)


# -- figures -----------------------------------------------------------------------

def figure_cases():
    import pandas as pd

    rng = np.random.default_rng(RNG_SEED)
    per_scenario = {f"Scenario {i}": values(60, i) for i in range(1, 4)}
    corr = np.corrcoef(rng.normal(size=(5, 30)))
    corr[0, 1] = corr[1, 0] = np.nan
    n = 40
    frame = pd.DataFrame({
        "gpt_relative_prob": rng.uniform(0, 1, n),
        "gemini_relative_prob": rng.uniform(0, 1, n),
        "gpt_weighted_confidence": rng.uniform(0, 100, n),
        "gemini_weighted_confidence": rng.uniform(0, 100, n),
        "claude_confidence": rng.uniform(0, 100, n),
        "gpt_response": rng.choice(["Yes", "No"], n),
        "gemini_response": rng.choice(["Yes", "No"], n),
        "claude_response": rng.choice(["Yes", "No"], n)})
    humans = {"models": {"GPT": {"mae": 0.21, "mae_ci_lower": 0.18,
                                 "mae_ci_upper": 0.24, "correlation": 0.61,
                                 "p_value": 0.0012, "n_matched": 50},
                         "Gemini": {"mae": 0.23, "std": 0.05,
                                    "correlation": 0.4}},
              "baselines": {"always_50": {"mae": 0.18},
                            "normal_human": {"mae": 0.27, "human_mean": 61.2,
                                             "human_std": 22.5}}}
    panels = {"GPT": {"s1": values(30, 1) * 100, "s2": values(30, 2) * 100},
              "Empty": {}}
    return {
        "histogram": ("probability_histogram", (values(), "Hist"), {}),
        "qq": ("qq_plot", (values(), "QQ"), {}),
        "truncated": ("truncated_model_plot",
                      (values(), np.clip(rng.normal(0.5, 0.3, 500), 0, 1),
                       "Fit"), {}),
        "jitter": ("jitter_strip_panels", (per_scenario, "Jitter"), {}),
        "heatmap": ("mae_heatmap", (rng.uniform(0, 1, (3, 6)),
                                    ["a", "b", "c"],
                                    [f"q{i}" for i in range(6)], "MAE"), {}),
        "error_strip": ("per_question_error_strip",
                        ({"m1": values(20, 3), "m2": values(20, 4)},
                         "Errors"), {}),
        "violin": ("violin_by_group", ({"g1": values(30, 5),
                                        "g2": values(30, 6)}, "Violin"), {}),
        "stacked": ("stacked_violin_panels", (panels,), {"refline": 50.0}),
        "dashboard": ("model_comparison_dashboard", (frame,),
                      {"correlations": {
                          "gpt_relative_prob__gemini_relative_prob":
                              {"pearson": 0.3}},
                       "human_comparisons": humans}),
        "mae_bar": ("mae_comparison_bar", (humans,), {}),
        "corr_heatmap": ("correlation_heatmap",
                         (corr, [f"m{i}" for i in range(5)], "Corr"), {}),
        "corr_distribution": ("correlation_distribution",
                              (corr[np.triu_indices(5, 1)][1:], "Dist"), {}),
    }


@pytest.mark.parametrize("case", sorted(figure_cases()))
def test_figures_equal_byte_for_byte(case, tmp_path):
    from llm_interpretation_replication_tpu_torch.viz import figures as tfigures

    name, args, kwargs = figure_cases()[case]
    out = {}
    for tag, mod in (("jax", jfigures), ("port", tfigures)):
        path = str(tmp_path / tag / f"{case}.png")
        if name in ("model_comparison_dashboard",):
            kwargs = dict(kwargs, output_path=path)
            # the port's dashboard takes the frame's row dicts
            rows = args if tag == "jax" else (args[0].to_dict("records"),)
            got = getattr(mod, name)(*rows, **kwargs)
        else:
            got = getattr(mod, name)(*args, path, **kwargs)
        assert got == path
        with open(path, "rb") as f:
            out[tag] = f.read()
    assert out["port"][:8] == b"\x89PNG\r\n\x1a\n"
    assert out["port"] == out["jax"]


def test_empty_inputs_draw_nothing(tmp_path):
    from llm_interpretation_replication_tpu_torch.viz import figures as tfigures

    assert tfigures.probability_histogram([np.nan], "t", str(tmp_path / "a.png")) \
        is None
    assert tfigures.qq_plot([1.0], "t", str(tmp_path / "b.png")) is None
    assert not (tmp_path / "a.png").exists()
