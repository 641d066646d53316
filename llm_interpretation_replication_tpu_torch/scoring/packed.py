"""Packed multi-question scoring (Auto-Demo batch prompting): Q questions
and their demonstrations in one sequence, scored at per-question answer
anchors in a single prefill (a copy of ``scoring/packed.py``).

A packed row amortizes one prefill over Q questions, and its binary leg
decodes nothing: the engine gathers the final hidden states at each
question's anchor (the last token of its prompt text) inside the prefill
(``models.decoder.forward_anchor_logits``) and runs the position-0 yes/no
scan over the gathered rows.

Packed mode is a measured-drift workload, not a bit-parity one: question
k >= 1 of a pack sees the earlier questions and their demonstration answers
as context, so its relative probability moves, and :func:`drift_report`
measures how far.  The first question of each pack tokenizes exactly as its
isolated prompt, so its anchor logits are the isolated ones.

Demonstrations follow Auto-Demo's self-generated convention when the caller
supplies them (the sweep's drift-parity leg feeds each question's own
isolated answer back as its demonstration); otherwise the scenario's yes
target stands in.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .prompts import PACKED_SEPARATOR, format_packed_demo as format_demo

__all__ = ["PACKED_SEPARATOR", "format_demo", "build_packs",
           "encode_packs", "drift_report", "demos_from_relative_probs",
           "autoregressive_demos"]


def autoregressive_demos(engine, prompts: Sequence[str], packing: int,
                         max_demo_tokens: int = 8,
                         repack: Optional[bool] = None):
    """Auto-Demo's autoregressive demonstrations: question k's demo is the
    model's own greedy continuation decoded in its pack's context so far
    (``ScoringEngine.packed_autoregressive_demos``, on the slot ring).
    Returns ``(packs, demos)``, ``packs`` in :func:`build_packs` layout;
    ``repack=False`` runs the same stages in whole flushes."""
    return engine.packed_autoregressive_demos(
        prompts, packing, max_demo_tokens=max_demo_tokens, repack=repack)


def build_packs(prompts: Sequence, packing: int,
                demos: Optional[Sequence[str]] = None) -> List[List[Tuple]]:
    """Group ``prompts`` into packs of ``packing`` consecutive questions.

    Each pack is a list of ``(prompt, demo_continuation)``: the text
    appended after the question's anchor (:func:`format_demo` of its own
    demonstration answer ``demos[i]``, "Yes" without ``demos``), and None
    for a pack's last question, whose following tokens no anchor reads.
    Question order is kept, pack-major."""
    if packing < 1:
        raise ValueError(f"packing must be >= 1, got {packing}")
    packs: List[List[Tuple]] = []
    for start in range(0, len(prompts), packing):
        chunk = list(prompts[start:start + packing])
        pack = []
        for j, prompt in enumerate(chunk):
            demo = None
            if j + 1 < len(chunk):
                answer = demos[start + j] if demos is not None else "Yes"
                demo = format_demo(answer)
            pack.append((prompt, demo))
        packs.append(pack)
    return packs


def encode_packs(tokenizer, packs: Sequence[Sequence[Tuple]]
                 ) -> Tuple[List[List[int]], List[List[int]]]:
    """Tokenize packs into one id stream a row plus each question's anchor.

    A pack's first prompt tokenizes as an isolated prompt (special tokens
    included); every later segment tokenizes without special tokens.
    ``anchors[i][k]`` is the index of question k's last prompt token in
    row i.  Prompts and demos may be pre-tokenized id lists; strings
    tokenize in one batched call a role (first prompts, later prompts,
    demos)."""
    rows: List[List[int]] = []
    anchors: List[List[int]] = []
    first_texts, later_texts, demo_texts = [], [], []
    for pack in packs:
        for k, (prompt, demo) in enumerate(pack):
            if isinstance(prompt, str):
                (first_texts if k == 0 else later_texts).append(prompt)
            if isinstance(demo, str):
                demo_texts.append(demo)
    first_ids = iter(tokenizer(first_texts)["input_ids"]
                     if first_texts else [])
    later_ids = iter(tokenizer(later_texts,
                               add_special_tokens=False)["input_ids"]
                     if later_texts else [])
    demo_ids = iter(tokenizer(demo_texts,
                              add_special_tokens=False)["input_ids"]
                    if demo_texts else [])
    for pack in packs:
        ids: List[int] = []
        offs: List[int] = []
        for k, (prompt, demo) in enumerate(pack):
            if isinstance(prompt, str):
                p_ids = next(first_ids) if k == 0 else next(later_ids)
            else:
                p_ids = prompt
            ids.extend(int(t) for t in p_ids)
            offs.append(len(ids) - 1)
            if demo is not None:
                d_ids = next(demo_ids) if isinstance(demo, str) else demo
                ids.extend(int(t) for t in d_ids)
        if not offs:
            raise ValueError("empty pack")
        rows.append(ids)
        anchors.append(offs)
    return rows, anchors


def drift_report(packed_rel: Sequence[float], isolated_rel: Sequence[float],
                 packing: int, flip_threshold: float = 0.5) -> Dict:
    """The drift block: the distribution of per-question |d relative_prob|
    between packed and isolated scoring, and the flip rate (questions whose
    verdict, relative_prob >= ``flip_threshold``, differs).  Rows NaN in
    either leg are left out and counted in ``n_skipped``.  A pure function
    of the two arrays."""
    packed_rel = np.asarray(packed_rel, dtype=np.float64)
    isolated_rel = np.asarray(isolated_rel, dtype=np.float64)
    if packed_rel.shape != isolated_rel.shape:
        raise ValueError(
            f"packed/isolated length mismatch: {packed_rel.shape} vs "
            f"{isolated_rel.shape}")
    ok = np.isfinite(packed_rel) & np.isfinite(isolated_rel)
    delta = np.abs(packed_rel[ok] - isolated_rel[ok])
    flips = ((packed_rel[ok] >= flip_threshold)
             != (isolated_rel[ok] >= flip_threshold))
    n = int(ok.sum())
    report = {
        "packing": int(packing),
        "n_questions": n,
        "n_skipped": int(ok.size - n),
        "flip_rate": round(float(flips.mean()), 4) if n else None,
    }
    if n:
        report.update(
            mean_abs_delta=round(float(delta.mean()), 6),
            p50_abs_delta=round(float(np.percentile(delta, 50)), 6),
            p90_abs_delta=round(float(np.percentile(delta, 90)), 6),
            max_abs_delta=round(float(delta.max()), 6),
        )
    else:
        report.update(mean_abs_delta=None, p50_abs_delta=None,
                      p90_abs_delta=None, max_abs_delta=None)
    return report


def demos_from_relative_probs(rel: Sequence[float],
                              target_pairs: Sequence[Sequence[str]]
                              ) -> List[str]:
    """Self-generated demonstrations from an isolated scoring pass: each
    question's answer is the target its own isolated relative probability
    favours (>= 0.5: the yes target); NaN rows take the yes target."""
    out = []
    for r, pair in zip(rel, target_pairs):
        yes, no = pair[0], pair[1]
        out.append(no if (np.isfinite(r) and float(r) < 0.5) else yes)
    return out
