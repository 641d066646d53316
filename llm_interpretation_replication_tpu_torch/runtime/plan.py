"""Execution planning: the generation schedule of one scoring leg, the
pools' quantized cache lengths, and the device-memory budget model (a copy
of ``runtime/plan.py``'s functions, with every coefficient measured on the
card by ``scripts/calibrate_plan_torch.py``).

The budget model predicts the peak ``torch.cuda.max_memory_allocated`` of
an operating point (model, quant, batch, sequence, KV dtype, prefill
chunk) as a sum of named terms: weights, the prompt forward's attention
transient, its activation live set, the completion path's pinned caches
and logits, and the pooled-confidence decode's pool.  A budget is the
card's memory less what the runtime holds beside the port's tensors
(``RESERVE_BYTES``: the CUDA context, cuBLAS and the kernels' libraries)
and, per workload, the caching allocator's slack (reserved beyond
allocated).  The card's memory is an argument; at an entry point it is
read from the card (:func:`device_memory_bytes`), and without a card an
entry point needs it given.

Departures from the reference's terms, for what eager PyTorch keeps alive
(each measured by the calibration script, PERF.md holds the peaks):

- no fusion: each term's bytes per element are the eager program's (the
  dense score tensor's bf16 product, fp32 biased scores, fp32 softmax and
  bf16 probabilities coexist; the w8a8 MLP's activation codes, int32
  accumulators and fp32 rescale do too), so the MLP's bytes depend on the
  quant (:func:`activation_bytes` takes it);
- chunked prefill replays its later chunks through the suffix-extension
  attention, whose products and sums run in float64
  (``ops.attention.grouped_attention_two_block``): its transient is priced
  on the kernel route too, where the reference prices the kernel's
  workspace alone;
- the fused legs extend each prefix by their format suffix through the
  same attention, a transient of its own (:func:`suffix_extend_bytes`);
- w8a8 weights keep the embedding table in bf16 (:func:`weight_bytes`);
- a joint K-token decode distills its K-head on the card before scoring,
  a float64 ridge solve a head (:func:`k_distill_bytes`);
- the loader converts (and quantizes) a snapshot on the card, a peak
  before the run that a small model's run may not reach
  (:func:`load_excess_bytes`; the plan search prices it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Calibrated coefficients (scripts/calibrate_plan_torch.py on the card)
# ---------------------------------------------------------------------------

#: What the runtime holds beside the port's tensors: the CUDA context,
#: cuBLAS's bf16 and int8 handles and workspaces and the attention kernels'
#: libraries (``torch.cuda.mem_get_info`` with the caching allocator
#: emptied), rounded up to 64 MiB.
RESERVE_BYTES = 11 << 26  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
#: The caching allocator's slack on the full-study path (the largest
#: ``max_memory_reserved - max_memory_allocated`` of its ladder), beyond
#: the reserve, rounded up to 64 MiB.
THRASH_HEADROOM_BYTES = 297 << 26  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
#: Dense prompt attention: peak bytes a [B, N, S, T] score element holds
#: (eager: the bf16 product and its scaled copy, the fp32 biased scores,
#: the fp32 softmax and the bf16 probabilities; q, k, v and the additive
#: bias folded in).
SCORE_BYTES_PER_ELEMENT = 11.09  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
#: Suffix-extension attention (chunked prefill's replays, the fused legs'
#: suffixes): peak bytes a [B, N, S, T] score element holds (float64
#: products, fp32 scores, exponentials and probabilities).
EXTEND_SCORE_BYTES_PER_ELEMENT = 18.22  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
#: The causal kernel's route: peak bytes a [B, S, N, D] query element holds
#: (the contiguous q, k and v the kernel takes and its bf16 output).
FLASH_BYTES_PER_ELEMENT = 17.06  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
#: Activation live set: bytes a [B, S, hidden] element holds (the residual
#: stream, the norm's output and the attention output beside the MLP).
ACT_HIDDEN_BYTES = 6.0  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
#: ... and a [B, S, intermediate] element of the MLP, bf16 projections.
ACT_MLP_BYTES = 4.0  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
#: ... and of the w8a8 MLP (fp32 copies of the activations around their
#: int8 codes, int32 accumulators and the fp32 rescale).
ACT_MLP_BYTES_INT8 = 14.01  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
#: The K-head's distillation on the card (``decoder.distill_k_head``, run
#: before the decode legs when no head is saved): peak bytes a [hidden,
#: vocab] element of one offset's ridge solve holds (its float64 right-hand
#: side and solution, the float32 and bf16 casts), beside the heads so far.
DISTILL_SOLVE_BYTES = 11.49  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
#: Loading a snapshot on the card (``runtime/loader.load_model``): the
#: peak above what was allocated before, in bytes a byte of the model's
#: bf16 weights (the checkpoint's tensors beside the converter's stacked
#: copies), read as bf16 ...
LOAD_BYTES_PER_WEIGHT_BYTE = 1.44  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
#: ... and read as w8a8 (the bf16 tree, then its int8 codes a layer at a
#: time).
LOAD_BYTES_PER_WEIGHT_BYTE_INT8 = 1.94  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
#: w8a8 weights: bytes an embedding-table parameter holds (the port keeps
#: the table in bf16 and quantizes the projections only).
INT8_EMBEDDING_BYTES = 2.0  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W


def device_memory_bytes(device: int = 0) -> int:
    """The card's memory (``torch.cuda.get_device_properties``); raises
    without a card, so a budget never falls back to a built-in size."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device to read the memory budget from: give the "
            "device's memory explicitly (hbm_bytes / --hbm-gib)")
    return int(torch.cuda.get_device_properties(device).total_memory)


def _hbm(hbm_bytes: Optional[int]) -> int:
    return device_memory_bytes() if hbm_bytes is None else int(hbm_bytes)


def param_count(cfg) -> int:
    """Decoder parameter count from the geometry (embeddings + L blocks)."""
    h, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    per_layer = h * nd + 2 * h * kvd + nd * h + 2 * h * f
    total = v * h + cfg.num_layers * per_layer
    if not getattr(cfg, "tie_word_embeddings", False):
        total += v * h
    return total


def _embedding_count(cfg) -> int:
    tables = 1 if getattr(cfg, "tie_word_embeddings", False) else 2
    return tables * cfg.vocab_size * cfg.hidden_size


def weight_bytes(cfg, quant: str) -> int:
    """bf16 = 2 B/param; w8a8 int8 = 1 B a projection parameter plus its
    fp32 per-channel scales (bounded here at 1%), and
    ``INT8_EMBEDDING_BYTES`` an embedding-table parameter."""
    n = param_count(cfg)
    if quant != "int8":
        return 2 * n
    emb = _embedding_count(cfg)
    return int(n * 1.01 + emb * (INT8_EMBEDDING_BYTES - 1.01))


def load_bytes(cfg, quant: str) -> int:
    """The peak of loading the model's snapshot on the card."""
    factor = (LOAD_BYTES_PER_WEIGHT_BYTE_INT8 if quant == "int8"
              else LOAD_BYTES_PER_WEIGHT_BYTE)
    return int(factor * weight_bytes(cfg, "none"))


def load_excess_bytes(cfg, quant: str, terms: dict) -> int:
    """What loading the snapshot needs beyond a run's live set
    (``terms``): the load peak comes before the run, so the run needs the
    larger of the two."""
    return max(0, load_bytes(cfg, quant) - sum(terms.values()))


def dense_attention_bytes(cfg, batch: int, seq: int,
                          prefill_chunk: int = 0) -> int:
    """The score transient of one dense-attention layer.

    ``prefill_chunk`` > 0 is chunked prefill: the widest transient is a
    later chunk's replay through the suffix-extension attention, a
    [B, chunk, T] query axis over the keys so far, at its own bytes per
    element."""
    if prefill_chunk:
        q = min(prefill_chunk, seq)
        return int(batch * cfg.num_heads * q * seq
                   * EXTEND_SCORE_BYTES_PER_ELEMENT)
    return int(batch * cfg.num_heads * seq * seq * SCORE_BYTES_PER_ELEMENT)


def suffix_extend_bytes(cfg, batch: int, seq: int, suffix_len: int) -> int:
    """The transient of a suffix extension over a ``seq``-slot prefix
    cache (the fused legs' format suffixes, ``decoder.extend_prefill``)."""
    return int(batch * cfg.num_heads * suffix_len * (seq + suffix_len)
               * EXTEND_SCORE_BYTES_PER_ELEMENT)


def activation_bytes(cfg, batch: int, seq: int,
                     prefill_chunk: int = 0, quant: str = "none") -> int:
    """Live activation set per layer step: the residual stream and the
    MLP's intermediate at the eager program's bytes (the w8a8 MLP's
    ``quant="int8"``).  Under chunked prefill only one chunk's activations
    are live at a time, so the token axis is bounded by the chunk."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    q = min(prefill_chunk, seq) if prefill_chunk else seq
    mlp = ACT_MLP_BYTES_INT8 if quant == "int8" else ACT_MLP_BYTES
    return int(batch * q * (ACT_HIDDEN_BYTES * h + mlp * f))


def kv_cache_bytes(cfg, batch: int, tokens: int,
                   kv_dtype: str = "bf16") -> int:
    """K+V cache bytes for ``tokens`` slots per row, dtype-aware.

    bf16 stores 2 B/element; int8 stores 1 B/element plus one fp32
    per-head scale per slot (``ops/quant.quantize_kv``: ``[L, B, T, G]``
    scales beside ``[L, B, T, G, D]`` codes), i.e. ``1 + 4/head_dim`` bytes
    per element."""
    if kv_dtype not in ("bf16", "int8"):
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    elems = cfg.num_layers * batch * tokens * cfg.num_kv_heads * cfg.head_dim
    if kv_dtype == "int8":
        scales = cfg.num_layers * batch * tokens * cfg.num_kv_heads
        return 2 * (elems + 4 * scales)          # k+v: codes + fp32 scales
    return 2 * elems * 2                         # k+v: bf16


def flash_workspace_bytes(cfg, batch: int, seq: int) -> int:
    """The causal kernel's route: its contiguous inputs and output."""
    return int(batch * seq * cfg.num_heads * cfg.head_dim
               * FLASH_BYTES_PER_ELEMENT)


def prefill_attention_bytes(cfg, attention_impl: str, batch: int, seq: int,
                            prefill_chunk: int = 0) -> int:
    """The attention transient of one prompt forward on ``attention_impl``:
    the kernel route's (or the dense score tensor's), and with chunked
    prefill the later chunks' extension replays, which run on either
    route."""
    if attention_impl != "flash":
        return dense_attention_bytes(cfg, batch, seq, prefill_chunk)
    ws = flash_workspace_bytes(cfg, batch, seq)
    if prefill_chunk and prefill_chunk < seq:
        return max(ws, dense_attention_bytes(cfg, batch, seq, prefill_chunk))
    return ws


def k_head_bytes(cfg, decode_k: int) -> int:
    """Memory the joint K-token decode's K-head pins: ``decode_k - 1``
    per-offset logit projections [H, V] in bf16 (``decoder.k_propose``
    reads them like a second lm_head)."""
    if decode_k <= 1:
        return 0
    return (decode_k - 1) * cfg.hidden_size * cfg.vocab_size * 2


def k_distill_bytes(cfg, decode_k: int) -> int:
    """The K-head distillation's transient beyond the head it leaves:
    one offset's ridge solve, and the bf16 heads kept so far with their
    stacked copy (4 bytes an element a head)."""
    if decode_k <= 1:
        return 0
    return int(cfg.hidden_size * cfg.vocab_size
               * (DISTILL_SOLVE_BYTES + 4 * (decode_k - 1)))


# ---------------------------------------------------------------------------
# Fit-decision formatting: one spelling for every budget audit
# ---------------------------------------------------------------------------

def budget_audit(need_bytes: int, budget_bytes: int) -> str:
    """``"{need} GiB of {budget}"``: the budget-audit fragment."""
    return f"{need_bytes / 2**30:.1f} GiB of {budget_bytes / 2**30:.1f}"


def budget_reject(need_bytes: int, budget_bytes: int) -> str:
    """``"{need} GiB > budget {budget}"``: the over-budget fragment."""
    return (f"{need_bytes / 2**30:.1f} GiB > budget "
            f"{budget_bytes / 2**30:.1f}")


def pooled_conf_tag(pool_bytes: int, pool_rows: int) -> str:
    """The pooled-confidence annotation appended to full-study reasons."""
    return (f" + pooled-conf pool {pool_bytes / 2**30:.1f} GiB "
            f"({pool_rows} rows)")


def full_study_fit_reason(batch: int, kv_dtype: str, prefill_chunk: int,
                          pool_tag: str, need_bytes: int, budget_bytes: int,
                          base_reason: str) -> str:
    """Reason string for a full-study operating point that fits as asked."""
    return (f"full-study fits at batch {batch} with {kv_dtype} KV"
            + (f" + prefill chunk {prefill_chunk}" if prefill_chunk else "")
            + pool_tag
            + f": {budget_audit(need_bytes, budget_bytes)}"
            + f" [{base_reason}]")


def full_study_clamp_reason(requested_batch: int, batch: int,
                            completions_bytes: int, kv_dtype: str,
                            pipeline_depth: int, prefill_chunk: int,
                            pool_tag: str, budget_bytes: int) -> str:
    """Reason string for a full-study batch clamped to fit the budget."""
    return (f"full-study row contract pins "
            f"{completions_bytes / 2**30:.1f} GiB "
            f"of {kv_dtype} KV completion caches/scores at depth "
            f"{pipeline_depth}"
            + (f" (prefill chunk {prefill_chunk})" if prefill_chunk else "")
            + pool_tag
            + f"; batch {requested_batch} -> {batch} to fit "
              f"{budget_bytes / 2**30:.1f} GiB")


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


def pooled_confidence_extra_bytes(cfg, target: int, seq: int,
                                  suffix_len: int = 64,
                                  score_steps: int = 10,
                                  kv_dtype: str = "bf16") -> int:
    """Peak K/V the pooled confidence decode pins beyond the per-batch
    live set (``engine._Phase2Pool`` on the confidence leg): up to
    ``target`` gathered row slices at the pool's quantized cache length
    (prefix bucket + format suffix), grown by the scored-decode steps,
    twice: the source slices and the flush's concatenated copy coexist
    until the decode runs.  The no-retirement worst case."""
    pool_len = conf_pool_len_for(seq + suffix_len)
    return 2 * kv_cache_bytes(cfg, target, pool_len + score_steps, kv_dtype)


def slot_refill_pool_bytes(cfg, target: int, batch: int, seq: int,
                           suffix_len: int = 64, score_steps: int = 10,
                           kv_dtype: str = "bf16") -> int:
    """The slot ring's confidence-pool peak (``runtime/slots.py``): at
    most ``target`` live rows grown by the scored steps, plus one prefill
    batch of gathered slices waiting for lanes; retired lanes' K/V drop at
    the next repack."""
    pool_len = conf_pool_len_for(seq + suffix_len)
    live = kv_cache_bytes(cfg, target, pool_len + score_steps, kv_dtype)
    pending = kv_cache_bytes(cfg, min(batch, target), pool_len, kv_dtype)
    return live + pending


def completions_extra_bytes(cfg, batch: int, seq: int,
                            gen_tokens: int = 50, score_steps: int = 10,
                            pipeline_depth: int = 2,
                            reduced_scores: bool = True,
                            kv_dtype: str = "bf16") -> int:
    """Extra live set of the full-study row contract (completions +
    confidence), per in-flight pipelined batch: the prefill's KV cache at
    the bucket length, the cache grown to ``seq + gen_tokens`` (old and new
    coexist while a chunk folds, so both count twice), and the fp32 [B, V]
    next-token logits.  The scored chunk keeps only ``ReducedScores``
    statistics; ``reduced_scores=False`` (a scan ``top_k`` beyond them)
    stacks fp32 [B, steps, V]."""
    cache_b = kv_cache_bytes(cfg, batch, seq, kv_dtype)
    cache_g = kv_cache_bytes(cfg, batch, seq + gen_tokens, kv_dtype)
    logits = batch * cfg.vocab_size * 4                      # fp32 [B, V]
    if reduced_scores:
        scores = batch * score_steps * 41 * 4                # ReducedScores
    else:
        scores = batch * score_steps * cfg.vocab_size * 4
    return pipeline_depth * (2 * (cache_b + cache_g) + logits + scores)


def prefix_cache_extra_bytes(cfg, batch: int, prefix_len: int,
                             n_legs: int = 2, suffix_len: int = 64,
                             pipeline_depth: int = 2) -> int:
    """Extra memory the fused prefix-reuse path (``score_prefixed``) pins
    per in-flight batch beyond the unfused live set: the shared prefix KV
    cache (bf16, k+v) plus each leg's extended copy (prefix + suffix
    slots)."""
    per_tok = cfg.num_layers * batch * cfg.num_kv_heads * cfg.head_dim * 2 * 2
    shared = per_tok * prefix_len
    legs = n_legs * per_tok * (prefix_len + suffix_len)
    return pipeline_depth * (shared + legs)


def full_study_need_terms(cfg, weight_b: int, attention_impl: str,
                          batch: int, seq: int, gen_tokens: int = 50,
                          score_steps: int = 10, pipeline_depth: int = 2,
                          reduced_scores: bool = True,
                          kv_dtype: str = "bf16", prefill_chunk: int = 0,
                          pooled_confidence: bool = False,
                          pool_target: Optional[int] = None,
                          decode_k: int = 1,
                          slot_repack: bool = False,
                          quant: str = "none",
                          suffix_len: int = 64) -> dict:
    """Per-term breakdown of the full-study live set at one operating
    point: the terms :func:`resolve_full_sweep_plan` sums, a dict so the
    plan search can divide each across the mesh axis that shards it.

    Keys: ``weights``, ``attn`` (the larger of the prompt forward's
    attention transient and the legs' suffix extension over
    ``suffix_len`` tokens), ``act``, ``completions``, ``conf_pool`` (0
    unless ``pooled_confidence``; the refill model when ``slot_repack``),
    plus ``k_head`` and ``k_distill`` (the head's distillation on the
    card, :func:`k_distill_bytes`) only when ``decode_k > 1``."""
    attn = max(prefill_attention_bytes(cfg, attention_impl, batch, seq,
                                       prefill_chunk),
               suffix_extend_bytes(cfg, batch, seq, suffix_len))
    conf_pool = 0
    if pooled_confidence and slot_repack:
        conf_pool = slot_refill_pool_bytes(
            cfg, pool_target or batch, batch, seq,
            score_steps=score_steps, kv_dtype=kv_dtype)
    elif pooled_confidence:
        conf_pool = pooled_confidence_extra_bytes(
            cfg, pool_target or batch, seq, score_steps=score_steps,
            kv_dtype=kv_dtype)
    terms = {
        "weights": weight_b,
        "attn": attn,
        "act": activation_bytes(cfg, batch, seq, prefill_chunk, quant),
        "completions": completions_extra_bytes(
            cfg, batch, seq, gen_tokens, score_steps, pipeline_depth,
            reduced_scores, kv_dtype),
        "conf_pool": conf_pool,
    }
    if decode_k > 1:
        terms["k_head"] = k_head_bytes(cfg, decode_k)
        distill = k_distill_bytes(cfg, decode_k)
        if distill:
            terms["k_distill"] = distill
    return terms


def packed_need_terms(cfg, weight_b: int, attention_impl: str,
                      batch_rows: int, packed_seq: int, packing: int,
                      pipeline_depth: int = 4, quant: str = "none") -> dict:
    """Per-term breakdown of the packed anchor-scoring sweep
    (``engine.score_packed``): weights, the prefill attention transient at
    the packed row length (quadratic in it on the dense route, which caps
    the packing factor), activations at the packed length, and the
    [B, K, V] fp32 anchor logits per in-flight batch on the
    ``completions`` key.  No pool, no KV cache, no decode."""
    return {
        "weights": weight_b,
        "attn": prefill_attention_bytes(cfg, attention_impl, batch_rows,
                                        packed_seq),
        "act": activation_bytes(cfg, batch_rows, packed_seq, quant=quant),
        "completions": pipeline_depth * batch_rows * packing
        * cfg.vocab_size * 4,
    }


@dataclasses.dataclass
class ScoringPlan:
    attention_impl: str        # "xla" (dense) or "flash" (the causal kernel)
    batch: int                 # possibly clamped from the request
    fits_dense: bool           # dense attention fits at the REQUESTED batch
    weight_bytes: int
    reason: str


def resolve_scoring_plan(cfg, quant: str, batch: int, seq: int,
                         hbm_bytes: Optional[int] = None,
                         requested_impl: Optional[str] = None,
                         prefill_chunk: int = 0) -> ScoringPlan:
    """Route a scoring sweep onto the card by fit alone:

    - dense attention (the port's default route) wherever weights + the
      dense score transient + activations fit;
    - otherwise the causal kernel's route, whose scores never materialize,
      with the batch clamped to the largest power of two that fits
      weights + activations + the kernel route's transient.

    ``requested_impl='flash'`` skips the dense check but still clamps the
    batch.  ``prefill_chunk`` > 0 budgets chunked prefill's transients;
    pass it only for paths that prefill through ``engine._prefill`` (the
    completions and fused-leg paths): the pooled binary path's
    ``_prefill_select`` prefills monolithic.  ``hbm_bytes`` None reads the
    card's memory (and raises without a card)."""
    wb = weight_bytes(cfg, quant)
    budget = _hbm(hbm_bytes) - RESERVE_BYTES
    dense_need = wb + dense_attention_bytes(cfg, batch, seq, prefill_chunk) \
        + activation_bytes(cfg, batch, seq, prefill_chunk, quant)
    fits_dense = dense_need <= budget
    if fits_dense and requested_impl != "flash":
        return ScoringPlan("xla", batch, True, wb,
                           f"dense fits: {budget_audit(dense_need, budget)}"
                           + (f" (prefill chunk {prefill_chunk})"
                              if prefill_chunk else ""))

    def flash_need(b):
        return wb + activation_bytes(cfg, b, seq, prefill_chunk, quant) \
            + prefill_attention_bytes(cfg, "flash", b, seq, prefill_chunk)

    if flash_need(batch) <= budget:
        clamped = batch            # requested batch fits: no clamp
    else:
        per_row = max(1, flash_need(1) - wb)
        b_max = max(1, int((budget - wb) // per_row))
        clamped = 1                # largest fitting power of two
        while clamped * 2 <= min(batch, b_max):
            clamped *= 2
    impl = "flash" if not fits_dense or requested_impl == "flash" else "xla"
    return ScoringPlan(
        impl, clamped, fits_dense, wb,
        f"dense needs {budget_reject(dense_need, budget)}; "
        f"flash at batch {clamped}"
        if not fits_dense else f"flash requested; batch {clamped}",
    )


def resolve_full_sweep_plan(cfg, quant: str, batch: int, seq: int,
                            gen_tokens: int = 50, score_steps: int = 10,
                            pipeline_depth: int = 2,
                            hbm_bytes: Optional[int] = None,
                            requested_impl: Optional[str] = None,
                            top_k: Optional[int] = None,
                            kv_dtype: str = "bf16",
                            prefill_chunk: int = 0,
                            pooled_confidence: bool = False,
                            pool_target: Optional[int] = None,
                            slot_repack: bool = False) -> ScoringPlan:
    """Route the full-study sweep (binary leg with completions + the
    confidence leg): resolve the attention route as a binary sweep does,
    then step the batch down by 32 until the live set with the completion
    path's pinned caches and logits (:func:`completions_extra_bytes`) and,
    with ``pooled_confidence``, the confidence pool's worst case fits the
    budget less the full-study path's allocator slack.

    ``top_k``: the engine's scan top-k when known (beyond
    ``ReducedScores``' kept candidates the engine stacks full fp32 score
    tensors)."""
    from ..models.decoder import REDUCED_TOPK

    reduced_scores = top_k is None or top_k <= REDUCED_TOPK
    hbm = _hbm(hbm_bytes)
    base = resolve_scoring_plan(cfg, quant, batch, seq, hbm,
                                requested_impl, prefill_chunk)
    wb = base.weight_bytes
    budget = hbm - RESERVE_BYTES - THRASH_HEADROOM_BYTES

    def terms(b):
        return full_study_need_terms(
            cfg, wb, base.attention_impl, b, seq, gen_tokens, score_steps,
            pipeline_depth, reduced_scores, kv_dtype, prefill_chunk,
            pooled_confidence, pool_target, slot_repack=slot_repack,
            quant=quant)

    def need(b):
        return sum(terms(b).values())

    b = min(batch, base.batch)
    if need(b) > budget:
        b = max(32, (b // 32) * 32)     # step through multiples of 32
        while b > 32 and need(b) > budget:
            b -= 32
    # the tag prices the pool at the fitted batch: with no explicit
    # pool_target the engine pools at its own batch_size
    fitted = terms(b)
    pool_tag = (pooled_conf_tag(fitted["conf_pool"], pool_target or b)
                if pooled_confidence else "")
    if b == base.batch:
        return dataclasses.replace(base, reason=full_study_fit_reason(
            b, kv_dtype, prefill_chunk, pool_tag, need(b), budget,
            base.reason))
    return ScoringPlan(
        base.attention_impl, b, base.fits_dense, wb,
        full_study_clamp_reason(batch, b, fitted["completions"], kv_dtype,
                                pipeline_depth, prefill_chunk, pool_tag,
                                budget),
    )
