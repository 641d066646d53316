"""Figure writers (reference L5 presentation layer).

Covers the reference's figure families (all Agg/matplotlib, saved as PNG):
- probability / confidence histograms (analyze_perturbation_results.py:623-722)
- QQ plots vs a fitted normal with 95% point bands (:499-622)
- clipped-normal model overlay (:340-498)
- combined per-scenario jitter-strip panels (:912-1094, the paper's Fig. 5/6)
- MAE heatmap and per-question error strips (evaluate_closed_source_models.py:
  1376-1586)
- violin plots for irrelevant-perturbation consistency
  (evaluate_irrelevant_perturbations.py:503-941)
- correlation heatmap + distribution histogram (model_comparison_graph.py:389-494)
- the survey and analysis modules' figures: the human-vs-model scatter, the
  ground-truth distribution panels, the reference-model difference strip and
  the stacked confidence strips (their modules compute, these draw)
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
from scipy import stats as scipy_stats  # noqa: E402


def _save(fig, output_path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    fig.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return output_path


def probability_histogram(values, title: str, output_path: str, bins: int = 50,
                          xlabel: str = "Relative probability") -> Optional[str]:
    values = np.asarray(values, float)
    values = values[np.isfinite(values)]
    if values.size == 0:
        return None
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.hist(values, bins=bins, range=(0, 1), edgecolor="black", alpha=0.75)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("Count")
    ax.set_title(title)
    ax.set_xlim(0, 1)
    return _save(fig, output_path)


def qq_plot(values, title: str, output_path: str) -> Optional[str]:
    """QQ plot vs fitted normal + histogram-with-fit side panel."""
    values = np.asarray(values, float)
    values = values[np.isfinite(values)]
    if values.size < 2:
        return None
    mu, sigma = scipy_stats.norm.fit(values)
    n = values.size
    ordered = np.sort(values)
    positions = (np.arange(1, n + 1) - 0.5) / n
    theoretical = scipy_stats.norm.ppf(positions)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(16, 8))
    ax1.scatter(theoretical, ordered, s=12, alpha=0.6)
    if np.var(ordered) > 0:
        slope, intercept = np.polyfit(theoretical, ordered, 1)
    else:
        slope, intercept = 0.0, ordered[0]
    xs = np.array([theoretical.min(), theoretical.max()])
    ax1.plot(xs, slope * xs + intercept, "r--", label="best fit")
    # pointwise 95% band via order-statistic std approximation
    band = 1.96 * sigma * np.sqrt(positions * (1 - positions) / n) / np.maximum(
        scipy_stats.norm.pdf(theoretical), 1e-6
    )
    ax1.fill_between(theoretical, slope * theoretical + intercept - band,
                     slope * theoretical + intercept + band, alpha=0.15)
    ax1.set_xlabel("Theoretical quantiles")
    ax1.set_ylabel("Ordered values")
    ax1.set_title(f"QQ plot — {title}")
    ax1.legend()
    ax2.hist(values, bins=40, density=True, alpha=0.6, edgecolor="black")
    grid = np.linspace(values.min() - 0.05, values.max() + 0.05, 200)
    ax2.plot(grid, scipy_stats.norm.pdf(grid, mu, sigma), "r-",
             label=f"N({mu:.3f}, {sigma:.3f})")
    ax2.set_title("Histogram with fitted normal")
    ax2.legend()
    return _save(fig, output_path)


def truncated_model_plot(values, simulated, title: str, output_path: str,
                         ks_statistic: Optional[float] = None) -> Optional[str]:
    values = np.asarray(values, float)
    values = values[np.isfinite(values)]
    simulated = np.asarray(simulated, float)
    if values.size == 0 or simulated.size == 0:
        return None
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(16, 6))
    bins = np.linspace(0, 1, 41)
    ax1.hist(values, bins=bins, density=True, alpha=0.55, label="observed",
             edgecolor="black")
    ax1.hist(simulated, bins=bins, density=True, alpha=0.4, label="clipped-normal model")
    ax1.set_title(title + (f" (KS={ks_statistic:.3f})" if ks_statistic is not None else ""))
    ax1.legend()
    # empirical CDFs
    for arr, label in ((values, "observed"), (simulated, "model")):
        xs = np.sort(arr)
        ax2.plot(xs, np.arange(1, xs.size + 1) / xs.size, label=label)
    ax2.set_title("Empirical CDFs")
    ax2.legend()
    return _save(fig, output_path)


def jitter_strip_panels(
    per_scenario_values: Dict[str, Sequence[float]],
    title: str,
    output_path: str,
    ylabel: str = "Relative probability",
    ylim=(0, 1),
    seed: int = 42,
) -> str:
    """One jittered strip per scenario with mean ± 95% CI markers (the
    Figure 5/6 style)."""
    rng = np.random.default_rng(seed)
    names = list(per_scenario_values)
    fig, ax = plt.subplots(figsize=(max(8, 2.2 * len(names)), 6))
    for i, name in enumerate(names):
        vals = np.asarray(per_scenario_values[name], float)
        vals = vals[np.isfinite(vals)]
        if vals.size == 0:
            continue
        x = i + rng.uniform(-0.18, 0.18, vals.size)
        ax.scatter(x, vals, s=6, alpha=0.25)
        mean = vals.mean()
        lo, hi = np.percentile(vals, [2.5, 97.5])
        ax.errorbar([i], [mean], yerr=[[mean - lo], [hi - mean]], fmt="o",
                    color="black", capsize=5, markersize=7, zorder=5)
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation=20, ha="right")
    ax.set_ylabel(ylabel)
    if ylim:
        ax.set_ylim(*ylim)
    ax.set_title(title)
    return _save(fig, output_path)


def mae_heatmap(mae_matrix, row_labels: Sequence[str], col_labels: Sequence[str],
                title: str, output_path: str) -> str:
    mat = np.asarray(mae_matrix, float)
    fig, ax = plt.subplots(figsize=(max(8, 0.3 * len(col_labels)), max(4, 0.5 * len(row_labels))))
    im = ax.imshow(mat, aspect="auto", cmap="RdYlGn_r")
    ax.set_xticks(range(len(col_labels)))
    ax.set_xticklabels(col_labels, rotation=90, fontsize=6)
    ax.set_yticks(range(len(row_labels)))
    ax.set_yticklabels(row_labels)
    fig.colorbar(im, ax=ax, label="Absolute error")
    ax.set_title(title)
    return _save(fig, output_path)


def per_question_error_strip(errors_by_model: Dict[str, Sequence[float]],
                             title: str, output_path: str) -> str:
    names = list(errors_by_model)
    fig, ax = plt.subplots(figsize=(10, 6))
    rng = np.random.default_rng(42)
    for i, name in enumerate(names):
        vals = np.asarray(errors_by_model[name], float)
        vals = vals[np.isfinite(vals)]
        x = i + rng.uniform(-0.15, 0.15, vals.size)
        ax.scatter(x, vals, s=10, alpha=0.5)
        ax.plot([i - 0.25, i + 0.25], [vals.mean()] * 2, color="black", lw=2)
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation=20, ha="right")
    ax.set_ylabel("Absolute error vs human mean")
    ax.set_title(title)
    return _save(fig, output_path)


def violin_by_group(values_by_group: Dict[str, Sequence[float]], title: str,
                    output_path: str, ylabel: str = "Confidence") -> Optional[str]:
    names = [k for k, v in values_by_group.items() if len(v)]
    data = [np.asarray(values_by_group[k], float) for k in names]
    data = [d[np.isfinite(d)] for d in data]
    if not data:
        return None
    fig, ax = plt.subplots(figsize=(max(8, 1.6 * len(names)), 6))
    ax.violinplot(data, showmeans=True, showextrema=True)
    ax.set_xticks(range(1, len(names) + 1))
    ax.set_xticklabels(names, rotation=20, ha="right")
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    return _save(fig, output_path)


def stacked_violin_panels(
    values_by_panel: Dict[str, Dict[str, Sequence[float]]],
    output_path: str,
    group_order: Optional[Sequence[str]] = None,
    ylabel: str = "Confidence (0-100)",
    xlabel: str = "Prompt Number",
    ylim=(0, 100),
    refline: Optional[float] = 50.0,
    seed: int = 42,
) -> str:
    """Vertically stacked per-model violin+jitter panels — the irrelevant-
    insertion study's ``three_model_stacked_visualization.png``
    (evaluate_irrelevant_perturbations.py:803-941): one subplot per panel
    (model), scenarios as numbered x positions with a consistent color per
    scenario across panels, jittered points, black mean dot, and capped
    2.5/97.5-percentile error bars.
    """
    panels = list(values_by_panel)
    groups = list(group_order) if group_order is not None else sorted(
        {g for per_group in values_by_panel.values() for g in per_group}
    )
    colors = plt.rcParams["axes.prop_cycle"].by_key()["color"]
    fig, axes = plt.subplots(len(panels), 1,
                             figsize=(14, 5.6 * len(panels)), squeeze=False)
    for pi, panel in enumerate(panels):
        ax = axes[pi][0]
        per_group = values_by_panel[panel]
        pos = 0
        ticks, labels = [], []
        for gi, group in enumerate(groups):
            vals = np.asarray(per_group.get(group, []), float)
            vals = vals[np.isfinite(vals)]
            if vals.size == 0:
                continue
            pos += 1
            ticks.append(pos)
            labels.append(str(gi + 1))
            color = colors[gi % len(colors)]
            parts = ax.violinplot([vals], [pos], widths=0.3, showmeans=False,
                                  showmedians=False, showextrema=False)
            for pc in parts["bodies"]:
                pc.set_facecolor(color)
                pc.set_edgecolor("none")
                pc.set_alpha(0.3)
            rng = np.random.default_rng(seed + gi)
            ax.scatter(rng.normal(pos, 0.08, vals.size), vals, alpha=0.4,
                       s=30, color=color)
            mean = vals.mean()
            lo, hi = np.percentile(vals, [2.5, 97.5])
            ax.scatter([pos], [mean], color="black", s=80, zorder=5)
            ax.plot([pos, pos], [lo, hi], color="black", lw=2, zorder=4)
            for y in (lo, hi):
                ax.plot([pos - 0.1, pos + 0.1], [y, y], color="black", lw=2,
                        zorder=4)
        if pos == 0:
            ax.text(0.5, 0.5, f"No data available for {panel}",
                    transform=ax.transAxes, ha="center", va="center",
                    fontsize=14)
            ax.set_xlim(0, len(groups) + 1)
        else:
            ax.set_xticks(ticks)
            ax.set_xticklabels(labels, fontsize=14)
            if refline is not None:
                ax.axhline(y=refline, color="gray", linestyle="--", alpha=0.7)
        ax.tick_params(axis="y", labelsize=14)
        ax.set_ylabel(ylabel, fontsize=16)
        if ylim:
            ax.set_ylim(*ylim)
        ax.set_title(panel, fontsize=18, fontweight="bold", pad=10)
        if pi == len(panels) - 1:
            ax.set_xlabel(xlabel, fontsize=16)
    fig.tight_layout()
    return _save(fig, output_path)


def _mae_bars(ax, human_comparisons: Dict, capsize: int = 5) -> None:
    """Shared MAE-vs-baselines bar panel (evaluate_closed_source_models.py:
    1690-1780 and the standalone figure :1832-1901): per-model MAE with
    asymmetric bootstrap-CI error bars, then the Always-50 and N(μ,σ)
    baselines in grey/cyan."""
    models = human_comparisons.get("models", human_comparisons)
    baselines = human_comparisons.get("baselines", {})
    labels, values, lo_err, hi_err, colors = [], [], [], [], []

    def push(record, label, color):
        mae = record.get("mae")
        if mae is None or not np.isfinite(mae):
            return
        labels.append(label)
        values.append(mae)
        lo = record.get("mae_ci_lower", record.get("ci_lower"))
        hi = record.get("mae_ci_upper", record.get("ci_upper"))
        if lo is not None and hi is not None and np.isfinite(lo) and np.isfinite(hi):
            lo_err.append(max(mae - lo, 0.0))
            hi_err.append(max(hi - mae, 0.0))
        else:
            std = record.get("std", record.get("mae_std", 0.0)) or 0.0
            lo_err.append(std)
            hi_err.append(std)
        colors.append(color)

    palette = {"gpt": "#1f77b4", "gemini": "#2ca02c", "claude": "#d62728"}
    for name, record in models.items():
        push(record, str(name), palette.get(str(name).lower(), "#9467bd"))
    if "always_50" in baselines:
        push(baselines["always_50"], "Always 50%", "#808080")
    if "normal_human" in baselines:
        rec = baselines["normal_human"]
        mu, sd = rec.get("human_mean"), rec.get("human_std")
        if mu is None or sd is None:
            label = "N(human)"
        else:
            # confidences are 0-100, relative probabilities 0-1: pick digits
            fmt = ".0f" if mu > 1 else ".2f"
            label = f"N({mu:{fmt}},{sd:{fmt}})"
        push(rec, label, "#17becf")
    if not values:
        ax.axis("off")
        return
    x = np.arange(len(values))
    ax.bar(x, values, yerr=np.array([lo_err, hi_err]), capsize=capsize,
           alpha=0.7, color=colors)
    for i, mae in enumerate(values):
        ax.text(i, mae + hi_err[i] + 0.01, f"{mae:.3f}", ha="center")
    ax.set_xticks(x)
    ax.set_xticklabels(labels, rotation=45, ha="right")
    ax.set_ylabel("Mean Absolute Error")
    ax.set_title("MAE vs human assessments (lower is better)")
    ax.grid(axis="y", alpha=0.3)


def _present(rows: Sequence[Dict], col: str) -> np.ndarray:
    """A column's non-NA values, as ``df[col].dropna()`` gives them."""
    return np.asarray([r[col] for r in rows if not _is_na(r.get(col))])


def _is_na(v) -> bool:
    return v is None or (isinstance(v, float) and v != v)


def model_comparison_dashboard(
    rows: Sequence[Dict],
    correlations: Optional[Dict] = None,
    human_comparisons: Optional[Dict] = None,
    output_path: str = "model_comparison_plots.png",
) -> str:
    """The closed-source evaluation dashboard (evaluate_closed_source_models.py
    `create_visualizations`, :1587-1830), over the results' row dicts:
    GPT-vs-Gemini scatter, per-model confidence histograms,
    binary-agreement heatmap, response-count bars, and -- when human
    comparisons exist -- the MAE bar chart, a correlation summary card, and
    confidence boxplots."""
    correlations = correlations or {}
    with_humans = bool(human_comparisons)
    columns = set(rows[0]) if rows else set()
    nrows = 3 if with_humans else 2
    fig, axes = plt.subplots(nrows, 3, figsize=(18, 4.7 * nrows))

    ax = axes[0, 0]
    if {"gpt_relative_prob", "gemini_relative_prob"} <= columns:
        pairs = np.asarray(
            [(r["gpt_relative_prob"], r["gemini_relative_prob"]) for r in rows
             if not (_is_na(r["gpt_relative_prob"])
                     or _is_na(r["gemini_relative_prob"]))], float).reshape(-1, 2)
        ax.scatter(pairs[:, 0], pairs[:, 1], alpha=0.6)
        ax.plot([0, 1], [0, 1], "r--", alpha=0.5)
        ax.set_xlabel("GPT relative probability")
        ax.set_ylabel("Gemini relative probability")
        rho = correlations.get("gpt_relative_prob__gemini_relative_prob", {})
        ax.set_title(f"GPT vs Gemini (ρ={rho.get('pearson', float('nan')):.3f})")
    else:
        ax.axis("off")

    hist_specs = [
        (axes[0, 1], "gpt_weighted_confidence", "GPT weighted confidence"),
        (axes[0, 2], "gemini_weighted_confidence", "Gemini weighted confidence"),
        (axes[1, 0], "claude_confidence", "Claude confidence"),
    ]
    for ax, col, title in hist_specs:
        vals = _present(rows, col) if col in columns else []
        if len(vals):
            ax.hist(vals, bins=20, edgecolor="black", alpha=0.7)
            ax.axvline(np.mean(vals), color="red", linestyle="--",
                       label=f"mean: {np.mean(vals):.1f}")
            ax.legend()
            ax.set_xlabel("Confidence")
            ax.set_ylabel("Frequency")
        ax.set_title(title)

    ax = axes[1, 1]
    names = ["gpt", "gemini", "claude"]
    cols = [f"{n}_response" for n in names]
    if all(c in columns for c in cols):
        agree = np.eye(3)
        for i, a in enumerate(cols):
            for j, b in enumerate(cols):
                if i != j:
                    both = [(r[a], r[b]) for r in rows
                            if not (_is_na(r[a]) or _is_na(r[b]))]
                    agree[i, j] = (np.mean([x == y for x, y in both])
                                   if both else np.nan)
        ax.imshow(agree, cmap="coolwarm", vmin=0, vmax=1)
        ax.set_xticks(range(3)), ax.set_yticks(range(3))
        ax.set_xticklabels(names), ax.set_yticklabels(names)
        for i in range(3):
            for j in range(3):
                if np.isfinite(agree[i, j]):
                    ax.text(j, i, f"{agree[i, j]:.2f}", ha="center", va="center",
                            color="white" if agree[i, j] < 0.5 else "black")
        ax.set_title("Binary-response agreement")
    else:
        ax.axis("off")

    ax = axes[1, 2]
    counts = {n: [r[f"{n}_response"] for r in rows]
              for n in names if f"{n}_response" in columns}
    if counts:
        table = np.array([[c.count(v) for v in ("Yes", "No")]
                          for c in counts.values()])
        x = np.arange(len(counts))
        ax.bar(x - 0.18, table[:, 0], width=0.36, label="Yes")
        ax.bar(x + 0.18, table[:, 1], width=0.36, label="No")
        ax.set_xticks(x)
        ax.set_xticklabels(list(counts), rotation=45, ha="right")
        ax.set_ylabel("Count")
        ax.set_title("Response distribution by model")
        ax.legend()
    else:
        ax.axis("off")

    if with_humans:
        _mae_bars(axes[2, 0], human_comparisons)

        ax = axes[2, 1]
        ax.axis("off")
        models = human_comparisons.get("models", human_comparisons)
        lines = ["Model-human correlations:", ""]
        for name, record in models.items():
            corr = record.get("correlation")
            if corr is None:
                continue
            lines.append(f"{name}:")
            lines.append(f"  correlation: {corr:.3f}")
            if record.get("p_value") is not None:
                lines.append(f"  p-value: {record['p_value']:.4f}")
            if record.get("n_matched") is not None:
                lines.append(f"  n matched: {record['n_matched']}")
            lines.append("")
        ax.text(0.05, 0.5, "\n".join(lines), fontsize=11, va="center",
                family="monospace")
        ax.set_title("Model-human correlations")

        ax = axes[2, 2]
        box_cols = [("gpt", "gpt_weighted_confidence"),
                    ("gemini", "gemini_weighted_confidence"),
                    ("claude", "claude_confidence")]
        data, labels = [], []
        for name, col in box_cols:
            vals = _present(rows, col) if col in columns else []
            if len(vals):
                data.append(np.asarray(vals, float))
                labels.append(name)
        if data:
            bp = ax.boxplot(data, tick_labels=labels, patch_artist=True)
            for patch, color in zip(bp["boxes"], ["lightblue", "lightgreen", "lightcoral"]):
                patch.set_facecolor(color)
            ax.set_ylabel("Confidence")
            ax.set_title("Confidence distributions")
            ax.grid(axis="y", alpha=0.3)
        else:
            ax.axis("off")

    fig.tight_layout()
    return _save(fig, output_path)


def mae_comparison_bar(human_comparisons: Dict, output_path: str) -> str:
    """Standalone high-quality MAE comparison chart
    (evaluate_closed_source_models.py:1832-1901)."""
    fig, ax = plt.subplots(figsize=(10, 6))
    _mae_bars(ax, human_comparisons, capsize=10)
    baselines = human_comparisons.get("baselines", {})
    if "always_50" in baselines and baselines["always_50"].get("mae") is not None:
        ax.axhline(y=baselines["always_50"]["mae"], color="gray", linestyle="--",
                   alpha=0.3)
    return _save(fig, output_path)


def correlation_heatmap(corr_matrix, labels: Sequence[str], title: str,
                        output_path: str) -> str:
    mat = np.asarray(corr_matrix, float)
    fig, ax = plt.subplots(figsize=(1 + 0.7 * len(labels), 1 + 0.6 * len(labels)))
    im = ax.imshow(mat, vmin=-1, vmax=1, cmap="coolwarm")
    ax.set_xticks(range(len(labels)))
    ax.set_xticklabels(labels, rotation=90, fontsize=7)
    ax.set_yticks(range(len(labels)))
    ax.set_yticklabels(labels, fontsize=7)
    for i in range(len(labels)):
        for j in range(len(labels)):
            if np.isfinite(mat[i, j]):
                ax.text(j, i, f"{mat[i, j]:.2f}", ha="center", va="center", fontsize=6)
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    return _save(fig, output_path)


def correlation_distribution(correlations, title: str, output_path: str) -> str:
    vals = np.asarray(correlations, float)
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.hist(vals, bins=20, edgecolor="black", alpha=0.75)
    ax.axvline(vals.mean(), color="red", linestyle="--",
               label=f"mean = {vals.mean():.3f}")
    ax.set_xlabel("Pairwise Pearson correlation")
    ax.set_ylabel("Count")
    ax.set_title(title)
    ax.legend()
    return _save(fig, output_path)


# -- the survey and analysis modules' own figures (their modules compute, these
# draw; each is the JAX package's drawing code, call for call)

def human_vs_model_scatter(h, m, model: str, pearson_r: float,
                           output_path: str) -> str:
    """Scatter of the best-correlated model vs humans with identity line
    (analyze_base_vs_instruct_vs_human.py:175-214)."""
    fig, ax = plt.subplots(figsize=(12, 8))
    ax.scatter(h, m, alpha=0.6)
    ax.plot([0, 1], [0, 1], "r--", alpha=0.5)
    ax.set_xlabel('Human Proportion "Yes"')
    ax.set_ylabel('Model Probability "Yes"')
    ax.set_title(f"Human vs Model Responses\n({model})")
    ax.set_xlim(-0.05, 1.05)
    ax.set_ylim(-0.05, 1.05)
    ax.text(0.05, 0.95, f"Pearson r = {pearson_r:.3f}",
            transform=ax.transAxes, verticalalignment="top")
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    fig.tight_layout()
    fig.savefig(output_path, dpi=150)
    plt.close(fig)
    return output_path


def ground_truth_distribution(pct, mean_pct: float, std_pct: float,
                              output_dir: str, smoother) -> Dict[str, str]:
    """Two-panel (histogram + fitted normal; random-baseline overlay) and
    simplified single-panel figures of the human ground truth
    (visualize_ground_truth_distribution.py:79-199); ``smoother(y, x)``
    smooths the simple panel's histogram."""
    x = np.linspace(0, 100, 200)

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(14, 6))
    ax1.hist(pct, bins=30, density=True, alpha=0.7, color="#2ca02c",
             edgecolor="black", label="Actual Human Responses")
    ax1.plot(x, scipy_stats.norm.pdf(x, mean_pct, std_pct), "r-", linewidth=2,
             label=f"Fitted Normal\nN({mean_pct:.1f}, {std_pct:.1f})")
    ax1.axvline(mean_pct, color="red", linestyle="--", linewidth=1.5,
                alpha=0.8, label=f"Mean: {mean_pct:.1f}%")
    ax1.axvline(mean_pct - std_pct, color="orange", linestyle=":", alpha=0.6)
    ax1.axvline(mean_pct + std_pct, color="orange", linestyle=":", alpha=0.6,
                label=f"±1 SD: {std_pct:.1f}%")
    ax1.set_xlabel('Percentage "Yes" Responses (%)')
    ax1.set_ylabel("Probability Density")
    ax1.set_title("Distribution of Human Ground Truth Values")
    ax1.set_xlim(0, 100)
    ax1.legend(loc="upper left", fontsize=9)

    rng = np.random.default_rng(42)
    samples = np.clip(rng.normal(mean_pct, std_pct, 10_000), 0, 100)
    ax2.hist(pct, bins=30, density=True, alpha=0.5, color="#2ca02c",
             edgecolor="black", label="Actual Human Data")
    ax2.hist(samples, bins=30, density=True, alpha=0.5, color="#17becf",
             edgecolor="black", label="Random Baseline\n(Sampled)")
    ax2.plot(x, scipy_stats.norm.pdf(x, mean_pct, std_pct), "r-", linewidth=2,
             alpha=0.8, label=f"Theoretical N({mean_pct:.1f}, {std_pct:.1f})")
    ax2.axvline(mean_pct, color="red", linestyle="--", alpha=0.8)
    ax2.set_xlabel('Percentage "Yes" Responses (%)')
    ax2.set_ylabel("Probability Density")
    ax2.set_title("Random Baseline Distribution")
    ax2.set_xlim(0, 100)
    ax2.legend(loc="upper left", fontsize=9)
    fig.suptitle("Ground Truth Distribution Analysis for Random Baseline")
    fig.tight_layout()
    two_panel = os.path.join(output_dir, "ground_truth_distribution.png")
    fig.savefig(two_panel, dpi=150, bbox_inches="tight")
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(10, 6))
    n, bins, _ = ax.hist(pct, bins=30, density=True, alpha=0.7,
                         color="#1f77b4", edgecolor="black")
    centers = (bins[:-1] + bins[1:]) / 2
    smoothed = smoother(n, centers)
    ax.plot(smoothed[:, 0], smoothed[:, 1], "r-", linewidth=2.5,
            label="Smoothed empirical distribution")
    ax.axvline(mean_pct, color="red", linestyle="--", linewidth=2, alpha=0.8,
               label=f"Mean = {mean_pct:.1f}%")
    ax.set_xlabel('Percentage of "Yes" Responses (%)')
    ax.set_ylabel("Probability Density")
    ax.set_xlim(0, 100)
    ax.legend(loc="upper left")
    fig.tight_layout()
    simple = os.path.join(output_dir, "ground_truth_distribution_simple.png")
    fig.savefig(simple, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return {"two_panel": two_panel, "simple": simple}


def difference_strip(diffs_by_model: Dict[str, np.ndarray],
                     reference_model: str, value_col: str,
                     output_path: str) -> str:
    """Per-model distribution of (model − reference) differences per prompt
    (model_comparison_graph.py:33-205)."""
    others = list(diffs_by_model)
    rng = np.random.default_rng(42)
    fig, ax = plt.subplots(figsize=(max(8, 1.6 * len(others)), 6))
    for i, model in enumerate(others):
        diffs = diffs_by_model[model]
        x = i + rng.uniform(-0.18, 0.18, diffs.size)
        ax.scatter(x, diffs, s=10, alpha=0.4)
        ax.plot([i - 0.3, i + 0.3], [np.mean(diffs)] * 2, color="black", lw=2)
    ax.axhline(0.0, color="grey", linestyle=":")
    ax.set_xticks(range(len(others)))
    ax.set_xticklabels([m.split("/")[-1] for m in others], rotation=30, ha="right")
    ax.set_ylabel(f"{value_col} − {reference_model.split('/')[-1]}")
    ax.set_title("Per-prompt differences vs reference model")
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    fig.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return output_path


def stacked_confidence_strips(values_by_model: Dict[str, Sequence[np.ndarray]],
                              n_scenarios: int, output_path: str) -> str:
    """One jitter-strip panel per model, stacked (Fig. 5/6 style;
    combine_model_confidence_analysis.py): ``values_by_model[model][i]`` is
    scenario i's confidences (empty arrays are skipped)."""
    models = list(values_by_model)
    fig, axes = plt.subplots(
        len(models), 1,
        figsize=(max(8, 2.0 * n_scenarios), 4 * len(models)),
        squeeze=False,
    )
    rng = np.random.default_rng(42)
    for ax_row, model in zip(axes, models):
        ax = ax_row[0]
        for i, vals in enumerate(values_by_model[model]):
            if not vals.size:
                continue
            x = i + rng.uniform(-0.18, 0.18, vals.size)
            ax.scatter(x, vals, s=6, alpha=0.25)
            mean = vals.mean()
            lo, hi = np.percentile(vals, [2.5, 97.5])
            ax.errorbar([i], [mean], yerr=[[mean - lo], [hi - mean]], fmt="o",
                        color="black", capsize=5, zorder=5)
        ax.set_title(model)
        ax.set_ylim(0, 100)
        ax.set_xticks(range(n_scenarios))
        ax.set_xticklabels([f"S{i + 1}" for i in range(n_scenarios)])
        ax.set_ylabel("Confidence")
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    fig.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return output_path
