"""Generation schedule of one scoring leg and the pools' quantized cache
lengths (a copy of ``runtime/plan.py``'s ``GenerationPlan``/
``plan_cache_key``/``generation_plan`` and ``POOL_LEN_MENU``/
``pool_len_for``/``conf_pool_len_for``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GenerationPlan:
    """Resolved per-call generation schedule for one scoring leg;
    ``cache_key`` includes the per-call ``max_new_tokens`` cap."""
    scan_steps: int             # scored look-ahead positions (MAX_LOOK_AHEAD)
    total_new_tokens: int       # completion decode length for this leg
    chunks: Tuple[int, ...]     # decode_steps chunk sizes covering the total
    cache_key: Tuple            # (scan_steps, total, decode_completions, cap)

    def __iter__(self):         # (steps, total) tuple unpacking
        return iter((self.scan_steps, self.total_new_tokens))

    def __eq__(self, other):
        if isinstance(other, tuple):
            return (self.scan_steps, self.total_new_tokens) == other
        return (isinstance(other, GenerationPlan)
                and self.cache_key == other.cache_key)

    def __hash__(self):
        return hash(self.cache_key)


def plan_cache_key(score_steps: int, max_look_ahead: int, default_cap: int,
                   decode_completions: bool,
                   max_new_tokens: Optional[int] = None) -> Tuple:
    """Engine-side lookup key for a leg's :class:`GenerationPlan`."""
    return (score_steps, max_look_ahead, default_cap,
            bool(decode_completions), max_new_tokens)


def generation_plan(score_steps: int, max_look_ahead: int, default_cap: int,
                    decode_completions: bool,
                    max_new_tokens: Optional[int] = None) -> GenerationPlan:
    """Scored-scan steps, the leg's total decode length (the per-call
    ``max_new_tokens`` override, never below the scored scan) and the decode
    chunk sizes."""
    steps = max(score_steps, max_look_ahead)
    cap = default_cap if max_new_tokens is None else max_new_tokens
    total = max(steps, cap) if decode_completions else steps
    chunks, offset = [], 0
    while offset < total:
        chunks.append(min(steps, total - offset))
        offset += chunks[-1]
    return GenerationPlan(steps, total, tuple(chunks),
                          cache_key=(steps, total, decode_completions, cap))


#: Quantized cache lengths of the cross-batch pools (``engine._Phase2Pool``):
#: every pooled slice is padded with inert invalid slots up to the menu entry
#: covering its cache length, so slices from different length buckets pool
#: and decode together.  The binary pool keeps the coarse menu (it holds only
#: the undecided rows); the confidence pool, which holds every row, the finer
#: one.
POOL_LEN_MENU = (256, 512, 1024, 2048)
CONF_POOL_LEN_MENU = (256, 320, 384, 512, 1024, 2048)


def pool_len_for(cache_len: int, menu=POOL_LEN_MENU) -> int:
    """Smallest pool-menu cache length covering ``cache_len``."""
    for t in menu:
        if cache_len <= t:
            return t
    return cache_len


def conf_pool_len_for(cache_len: int) -> int:
    """Confidence-pool quantized cache length (the finer menu)."""
    return pool_len_for(cache_len, CONF_POOL_LEN_MENU)
