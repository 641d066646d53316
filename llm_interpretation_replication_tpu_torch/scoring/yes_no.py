"""Yes/No relative-probability extraction (port of ``scoring/yes_no.py``).

The scan looks at the first ``max_look_ahead`` generated positions for one
whose top-k contains the Yes or No token and reads the probabilities there,
falling back to position 0.  Top-k membership is ``prob >= k-th largest``:
exact ties with the k-th candidate count as members, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..device import to_device


class YesNoResult(NamedTuple):
    yes_prob: torch.Tensor       # [B]
    no_prob: torch.Tensor        # [B]
    relative_prob: torch.Tensor  # [B]  p_yes / (p_yes + p_no), 0.5 when both 0
    odds_ratio: torch.Tensor     # [B]  p_yes / p_no, +inf when p_no == 0
    found: torch.Tensor          # [B]  bool: scan hit within max_look_ahead
    position: torch.Tensor       # [B]  int: position read (0 on fallback)


def _ids(ids, b: int, device) -> torch.Tensor:
    return to_device(ids, device, torch.int64).expand(b)


def _scan(p_yes, p_no, hit, look: int, valid_steps) -> YesNoResult:
    """Shared tail of both scans: first hit within ``look`` visible steps."""
    hit = hit[:, :look]
    if valid_steps is not None:
        steps = torch.arange(look, device=hit.device)
        hit = hit & (steps[None, :] < valid_steps[:, None])
    found = hit.any(dim=1)
    first = torch.argmax(hit.to(torch.int32), dim=1)   # first True
    sel = torch.where(found, first, 0)
    yes = torch.gather(p_yes, 1, sel[:, None])[:, 0]
    no = torch.gather(p_no, 1, sel[:, None])[:, 0]
    total = yes + no
    relative = torch.where(total > 0, yes / torch.where(total > 0, total, 1.0), 0.5)
    odds = torch.where(no > 0, yes / torch.where(no > 0, no, 1.0), float("inf"))
    return YesNoResult(yes, no, relative, odds, found, sel.to(torch.int32))


def yes_no_from_scores(scores, yes_id, no_id, max_look_ahead: int = 10,
                       top_k: int = 5, valid_steps=None) -> YesNoResult:
    """Scan over full per-step scores ``[B, P, V]``.  ``valid_steps`` [B]:
    scan-visible positions per row (the reference's score list ends at the
    EOS-emitting position)."""
    b, p, _ = scores.shape
    probs = torch.softmax(scores.float(), dim=-1)
    yes_id = _ids(yes_id, b, scores.device)
    no_id = _ids(no_id, b, scores.device)
    p_yes = torch.gather(probs, 2, yes_id[:, None, None].expand(b, p, 1))[..., 0]
    p_no = torch.gather(probs, 2, no_id[:, None, None].expand(b, p, 1))[..., 0]
    kth = torch.topk(probs, top_k, dim=-1).values[..., -1]          # [B,P]
    hit = (p_yes >= kth) | (p_no >= kth)
    return _scan(p_yes, p_no, hit, min(max_look_ahead, p), valid_steps)


def yes_no_from_reduced(topk_vals, logz, target_logits,
                        max_look_ahead: int = 10, top_k: int = 5,
                        valid_steps=None) -> YesNoResult:
    """:func:`yes_no_from_scores` on ``ReducedScores`` statistics: top-k
    membership compares raw logits with the k-th largest logit (softmax is
    monotone), probabilities are ``exp(logit - logsumexp)``."""
    b, p, k = topk_vals.shape
    if top_k > k:
        raise ValueError(f"top_k={top_k} > {k} kept candidates")
    p_yes = torch.exp(target_logits[..., 0] - logz)
    p_no = torch.exp(target_logits[..., 1] - logz)
    kth = topk_vals[..., top_k - 1]
    hit = (target_logits[..., 0] >= kth) | (target_logits[..., 1] >= kth)
    return _scan(p_yes, p_no, hit, min(max_look_ahead, p), valid_steps)


def steps_until_eos(tokens, eos_id) -> torch.Tensor:
    """[B, P] greedy tokens -> [B] scan-visible position count: up to and
    including the first EOS, else all P."""
    b, p = tokens.shape
    if eos_id is None:
        return torch.full((b,), p, dtype=torch.int32, device=tokens.device)
    is_eos = tokens == eos_id
    first = torch.argmax(is_eos.to(torch.int32), dim=1)
    return torch.where(is_eos.any(dim=1), first + 1, p).to(torch.int32)


def first_token_scan(logits, yes_id, no_id, top_k: int = 5):
    """Position-0 leg of the scan on prefill logits [B, V]: (yes, no,
    relative, odds, hit) -- :func:`yes_no_from_scores` on one position."""
    res = yes_no_from_scores(logits[:, None, :], yes_id, no_id,
                             max_look_ahead=1, top_k=top_k)
    return res.yes_prob, res.no_prob, res.relative_prob, res.odds_ratio, res.found


def relative_prob_first_token(logits, yes_id, no_id, top_filter: int = 0):
    """Position-0 probabilities [B] of yes/no from logits [B, V]; with
    ``top_filter`` > 0 a probability outside the top-N reads as 0 (the API
    extractor's top-20-logprobs view)."""
    probs = torch.softmax(logits.float(), dim=-1)
    b = logits.shape[0]
    yes = torch.gather(probs, 1, _ids(yes_id, b, logits.device)[:, None])[:, 0]
    no = torch.gather(probs, 1, _ids(no_id, b, logits.device)[:, None])[:, 0]
    if top_filter:
        kth = torch.topk(probs, top_filter, dim=-1).values[:, -1]
        yes = torch.where(yes >= kth, yes, 0.0)
        no = torch.where(no >= kth, no, 0.0)
    total = yes + no
    relative = torch.where(total > 0, yes / torch.where(total > 0, total, 1.0), 0.5)
    return yes, no, relative


def target_token_ids(tokenizer, targets: Sequence[str], encoder_decoder: bool = False):
    """Token ids the scan looks for: the first id of ``" " + target``
    (leading-space convention) with a no-space fallback; encoder-decoder
    models take the first id of the bare word."""
    ids = []
    for t in targets:
        if encoder_decoder:
            ids.append(tokenizer(t).input_ids[0])
            continue
        with_space = tokenizer(" " + t, add_special_tokens=False).input_ids
        ids.append(with_space[0] if with_space else tokenizer.encode(t)[0])
    return ids
