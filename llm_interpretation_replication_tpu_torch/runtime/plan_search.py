"""Plan search: pick the operating point from the model (a copy of
``runtime/plan_search.py``, its coefficients measured on the card by
``scripts/calibrate_plan_torch.py``).

The search enumerates the candidate space

    mesh shapes over the device count (parallel/mesh.enumerate_mesh_shapes)
    x batch (a step-32 ladder)
    x kv_dtype {bf16, int8}
    x prefill_chunk {0, 64, 128, 256}
    x pooled-confidence pool target
    x joint decode block K (full study) / packing factor Q (packed)

rejects candidates whose per-device live set (the budget model's terms,
``plan.full_study_need_terms`` and its siblings, and loading the snapshot
on the card where that needs more, each divided across the mesh axis
that shards it) exceeds the card's memory less the runtime's
reserve and the workload's allocator slack, and ranks the survivors by a
predicted rows/s.  The chosen plan and a ranked runner-up table with each
candidate's fit or reject reason go to stderr or a JSON record; the
engine's OOM ladder stays armed for a prediction the card does not keep.
The search picks shapes and batch sizes and never touches scoring
numerics.  A chosen mesh larger than one device cannot run yet: the
scoring engine on a mesh waits for ROADMAP.md queue 1's 'Parallel and
training'.

Cost model
----------
``rate(B) = CEIL * sat(B_dev)`` with ``sat(b) = b / (b + HALF)``, a
saturating per-device rate in binary-leg rows/s, fitted to the card's
binary-leg rows/s at three batches.  The full-study row has a curve of its
own (a departure: on the card its decode-bound rows saturate at a larger
batch than the binary leg's), ``CEIL / WORK * b / (b + FULL_HALF)``,
fitted to its rows/s at the same batches.  Mesh axes
apply as a data-parallel multiplier, a tensor-parallel collective penalty
per extra tp degree, and the measured int8-KV and chunked-prefill
penalties.  The rates were measured on random weights, which decide no
row at position 0 (every binary row decodes its look-ahead); a bench on
the study's decided share should re-anchor them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

from . import plan as plan_mod
from .plan import (
    budget_audit,
    budget_reject,
    full_study_need_terms,
    weight_bytes,
)


# ---------------------------------------------------------------------------
# Calibrated cost-model coefficients
# ---------------------------------------------------------------------------

#: Saturating per-device binary-leg rate: the rows/s ceiling and the batch
#: at half of it, fitted to the binary leg's rows/s at three batches
#: (w8a8, the causal kernel's route, the corpus).
ROWS_CEILING = 74.77  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
BATCH_HALF_SAT = 56.82  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
#: The full-study row's own saturating curve, fitted to its rows/s at the
#: same three batches: the batch at half its ceiling, and the binary
#: ceiling over its ceiling (binary-leg equivalents per full-study row at
#: saturation).  Decode-bound, it saturates at a larger batch than the
#: binary leg.
FULL_STUDY_HALF_SAT = 361.4  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
FULL_STUDY_WORK = 0.949  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
#: Collective overhead per extra tensor-parallel degree.
TP_COMM_PENALTY = 0.07  # prior: one card, no tensor-parallel run to measure; the pjit scaling playbook's overhead regime
#: int8 KV cache: the full-study rows/s lost against a bf16 cache.
INT8_KV_PENALTY = 0.0  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
#: Chunked prefill: the full-study rows/s lost a chunk replay.
CHUNK_PENALTY = 0.0  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
#: Parameter count of the geometry the rates were measured on (Falcon-7B);
#: other geometries scale the rate by the parameter ratio.
CALIBRATION_PARAMS = 6_921_420_800  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W

# -- joint next-K-token decode (models/decoder.k_verify_block) --------------
#: Per-position proposal-accept prior for the K-head on the decode legs.
K_ACCEPT_PRIOR = 0.9  # prior: random weights accept no block on the card; short predictable continuations (K-Forcing regime)
#: Fraction of the full-study per-row time spent in the decode legs: what
#: K-decode can touch (Amdahl).
K_DECODE_SHARE = 0.763  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
#: decode_k values the full-study search enumerates (1 = sequential).
DEFAULT_DECODE_KS = (1, 2, 4, 8)


def k_decode_speedup(decode_k: int, accept: float = K_ACCEPT_PRIOR) -> float:
    """Expected decode-leg speedup of verify-and-accept at block size K.

    Per proposed block: position 0 is the free exact argmax, positions
    1..K-1 each hold with probability ``accept``, and acceptance is
    all-or-nothing per block: with probability ``accept^(K-1)`` the block
    costs ~1 weight stream for K tokens, otherwise the pass is wasted and
    the block's positions re-run sequentially (1 + K streams).  Speedup =
    K / expected streams, non-monotone in K.  Exact when the block is the
    chunk, optimistic for multi-block chunks (a late block's reject
    re-runs the whole chunk)."""
    k = int(decode_k)
    if k <= 1:
        return 1.0
    p_blk = accept ** (k - 1)
    return k / (p_blk + (1.0 - p_blk) * (1.0 + k))


# -- disaggregated prefill/decode roles (serve/pool.py) ----------------------
#: Fraction of a binary row's time spent in prefill and the position-0
#: scan (the rest is the pooled look-ahead decode a ``role="prefill"``
#: replica never runs).
PREFILL_PHASE_SHARE = 0.705  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
#: Slot-ring residency gain a ``role="decode"`` specialist sees from
#: imported KV slabs (its ring refills from the handoff queue).
DECODE_REFILL_GAIN = 1.08  # prior: one card, no roles run to measure; the occupancy block's refill tail model


def role_rate_factor(role: Optional[str], *, prefill_chunk: int = 0,
                     seq: int = 256, pool_target: int = 0,
                     decode_k: int = 1) -> float:
    """Multiplier taking a symmetric binary-workload rate estimate to a
    role-specialist estimate (serve/pool.py disaggregation).

    ``"prefill"``: the replica runs only the prefill share of each row,
    and chunk replays charge against the prefill-only row.  ``"decode"``:
    only the decode share, with the slot-refill gain on pooled candidates
    and the full K-decode speedup.  ``None`` returns 1.0."""
    if role is None:
        return 1.0
    if role == "prefill":
        replays = 0
        if prefill_chunk and prefill_chunk < seq:
            replays = -(-seq // prefill_chunk) - 1
        # un-apply the symmetric chunk discount, then charge the replay
        # cost absolutely against the prefill-only row
        sym = max(0.05, 1.0 - CHUNK_PENALTY * replays)
        return 1.0 / (sym * (PREFILL_PHASE_SHARE
                             + CHUNK_PENALTY * replays))
    if role == "decode":
        factor = 1.0 / (1.0 - PREFILL_PHASE_SHARE)
        if pool_target:
            factor *= DECODE_REFILL_GAIN
        if decode_k > 1:
            factor *= k_decode_speedup(decode_k)
        return factor
    raise ValueError(
        f"role must be None, 'prefill', or 'decode': {role!r}")


# -- packed batch prompting (scoring/packed.py) -------------------------------
#: Mean tokens of a corpus question's binary prompt (text and format).
PACKED_QUESTION_TOKENS = 118.46  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
#: Tokens a packed row pays once for all its questions: none, since each
#: question keeps its own format suffix in the port's packs.
PACKED_SHARED_TOKENS = 0.0  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
#: Demonstration tokens a packed row adds per question.
PACKED_DEMO_TOKENS = 0.75  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
#: Packed questions/s over the binary curve at the same question batch,
#: net of the token ratio.
PACKED_NO_DECODE_GAIN = 2.973  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W
#: Packing factors the search enumerates.
DEFAULT_PACKINGS = (1, 2, 4, 8)
#: The caching allocator's slack on the packed sweep beyond the reserve.
PACKED_SWEEP_HEADROOM_BYTES = 306 << 26  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W


def packed_seq_tokens(packing: int,
                      question_tokens: Optional[float] = None,
                      shared_tokens: Optional[float] = None,
                      demo_tokens: Optional[float] = None) -> int:
    """Expected packed-row token length at one packing factor: the shared
    scaffold once per row plus Q (question + demonstration) segments (each
    count None: the module's coefficient)."""
    if question_tokens is None:
        question_tokens = PACKED_QUESTION_TOKENS
    if shared_tokens is None:
        shared_tokens = PACKED_SHARED_TOKENS
    if demo_tokens is None:
        demo_tokens = PACKED_DEMO_TOKENS
    return int(round(shared_tokens
                     + packing * (question_tokens + demo_tokens)))


#: The caching allocator's slack on the binary sweep beyond the reserve.
BINARY_SWEEP_HEADROOM_BYTES = 290 << 26  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 80GB HBM3, 700.00 W

# ---------------------------------------------------------------------------
# Candidate space defaults
# ---------------------------------------------------------------------------

DEFAULT_BATCH_LADDER = tuple(range(32, 513, 32))
DEFAULT_KV_DTYPES = ("bf16", "int8")
DEFAULT_PREFILL_CHUNKS = (0, 64, 128, 256)
#: Pool targets for the pooled-confidence decode: 0 = the engine default
#: (pool at batch size); the others sit on the confidence pool's menu.
DEFAULT_POOL_TARGETS = (0, 192, 320)

#: The reference's hand-picked dp x tp scoring mesh of eight devices, the
#: operating point the dryrun's choice must reproduce or beat.
HAND_PICKED_MULTICHIP = {"data": 4, "pipe": 1, "model": 2}


@dataclasses.dataclass(frozen=True)
class PlanCandidate:
    """One point of the search space with its budget verdict and rank."""

    data: int
    pipe: int
    model: int
    batch: int
    kv_dtype: str
    prefill_chunk: int
    pool_target: int            # 0 = pool at batch size (engine default)
    fits: bool
    reason: str                 # fit/reject audit (plan.budget_audit spelling)
    need_bytes: int             # per-device live set (0 when pre-budget reject)
    predicted_rows_per_s: float  # 0.0 when rejected
    packing: int = 1            # questions per packed row (1 = isolated)
    decode_k: int = 1           # joint K-token decode block size (1 = sequential)

    @property
    def mesh_shape(self) -> Dict[str, int]:
        return {"data": self.data, "pipe": self.pipe, "model": self.model}

    def as_record(self) -> Dict:
        """JSON-able row of the runner-up table."""
        return {
            "mesh": self.mesh_shape,
            "batch": self.batch,
            "kv_dtype": self.kv_dtype,
            "prefill_chunk": self.prefill_chunk,
            "pool_target": self.pool_target,
            "packing": self.packing,
            "decode_k": self.decode_k,
            "fits": self.fits,
            "predicted_rows_per_s": round(self.predicted_rows_per_s, 2),
            "need_gib": round(self.need_bytes / 2**30, 2),
            "reason": self.reason,
        }


def predicted_rows_per_s(cfg, data: int, model: int, batch: int,
                         kv_dtype: str = "bf16", prefill_chunk: int = 0,
                         workload: str = "full", seq: int = 256,
                         packing: int = 1, decode_k: int = 1) -> float:
    """Calibrated throughput estimate for one candidate (module docstring).

    ``workload``: "binary" (prompts/s), "full" (full-study rows/s), or
    "packed" (questions/s; ``batch`` counts packed rows, ``packing``
    questions ride each).  ``seq`` sizes the chunked-prefill replay count.

    The packed estimate reuses the binary curve at the question batch,
    scaled by the measured packed gain and the per-question token ratio
    ``(SHARED + QUESTION) / (SHARED/Q + QUESTION + DEMO)``."""
    per_dev_batch = batch / data
    if workload == "packed":
        per_dev_batch *= max(1, packing)
    half = FULL_STUDY_HALF_SAT if workload == "full" else BATCH_HALF_SAT
    sat = per_dev_batch / (per_dev_batch + half)
    scale = CALIBRATION_PARAMS / max(1, plan_mod.param_count(cfg))
    rate = ROWS_CEILING * scale * sat * data
    rate /= 1.0 + TP_COMM_PENALTY * (model - 1)
    if kv_dtype == "int8":
        rate *= 1.0 - INT8_KV_PENALTY
    if prefill_chunk and prefill_chunk < seq:
        replays = -(-seq // prefill_chunk) - 1
        rate *= 1.0 - CHUNK_PENALTY * replays
    if workload == "full":
        rate /= FULL_STUDY_WORK
        if decode_k > 1:
            # Amdahl over the decode share, priced by the accept prior
            rate /= (1.0 - K_DECODE_SHARE
                     + K_DECODE_SHARE / k_decode_speedup(decode_k))
    elif workload == "packed":
        q = max(1, packing)
        iso_tokens = PACKED_SHARED_TOKENS + PACKED_QUESTION_TOKENS
        per_q_tokens = (PACKED_SHARED_TOKENS / q + PACKED_QUESTION_TOKENS
                        + PACKED_DEMO_TOKENS)
        rate *= PACKED_NO_DECODE_GAIN * iso_tokens / per_q_tokens
    return rate


def sharded_need_bytes(terms: Dict[str, int], cfg, data: int, model: int,
                       pipe: int) -> int:
    """Per-device live set: each plan.py term divided across the mesh axis
    that shards it.  Weights shard over tp and pp; batch-leading
    transients over dp; KV-cache terms over tp only when the kv heads
    divide (an MQA cache is replicated per tp shard).  Departure from the
    reference, which also divides the KV-cache terms over dp: each data
    rank of the port holds the whole cache between device calls
    (``runtime/row_parallel.py``), so they count whole on every rank."""
    head_div = model if cfg.num_heads % model == 0 else 1
    kv_heads = cfg.num_kv_heads or cfg.num_heads
    kv_div = model if kv_heads % model == 0 else 1
    return (terms["weights"] // (model * pipe)
            + terms["attn"] // (data * head_div)
            + terms["act"] // data
            + terms.get("completions", 0) // kv_div
            + terms.get("conf_pool", 0) // kv_div
            # the K-head is a second lm_head: sharded like the weights, as
            # is its distillation's solve
            + terms.get("k_head", 0) // (model * pipe)
            + terms.get("k_distill", 0) // (model * pipe)
            # loading is per device, on its shard of the weights
            + terms.get("load", 0) // (model * pipe))


def binary_need_terms(cfg, weight_b: int, batch: int, seq: int,
                      pipeline_depth: int = 4,
                      attention_impl: str = "xla",
                      quant: str = "none") -> Dict[str, int]:
    """Per-term live set of the binary pooled look-ahead sweep: weights,
    the monolithic prefill's attention transient, activations, and the
    path's extras: the byte-capped cross-batch pool
    (``EngineConfig.phase2_pool_max_bytes``, 512 MiB) plus the in-flight
    fp32 [B, V] logits at the sweep's pipeline depth.  Keys mirror
    :func:`plan.full_study_need_terms`."""
    return {
        "weights": weight_b,
        "attn": plan_mod.prefill_attention_bytes(cfg, attention_impl, batch,
                                                 seq),
        "act": plan_mod.activation_bytes(cfg, batch, seq, quant=quant),
        # batch-leading extras ride the "completions" key
        "completions": (512 << 20) + pipeline_depth * batch
        * cfg.vocab_size * 4,
    }


def search_plans(cfg, quant: str, n_devices: int, seq: int = 256,
                 workload: str = "full",
                 batches: Sequence[int] = DEFAULT_BATCH_LADDER,
                 kv_dtypes: Sequence[str] = DEFAULT_KV_DTYPES,
                 prefill_chunks: Sequence[int] = DEFAULT_PREFILL_CHUNKS,
                 pool_targets: Optional[Sequence[int]] = None,
                 gen_tokens: int = 50, score_steps: int = 10,
                 pipeline_depth: int = 2,
                 hbm_bytes: Optional[int] = None,
                 max_pipe: int = 2,
                 max_model: Optional[int] = None,
                 attention_impl: str = "xla",
                 packings: Sequence[int] = DEFAULT_PACKINGS,
                 decode_ks: Sequence[int] = DEFAULT_DECODE_KS,
                 slot_repack: bool = False) -> List[PlanCandidate]:
    """Enumerate, budget-filter, and rank the candidate space.

    Returns every candidate, ranked: fitting plans first by predicted
    rows/s (ties toward the simpler config: lower tp, pp, pool target,
    packing), then rejected plans.  ``ranked[0]`` is the chosen plan when
    any candidate fits.  ``hbm_bytes`` None reads the card's memory.

    ``slot_repack=True`` prices the confidence pool with the refill model
    (``plan.slot_refill_pool_bytes``) instead of the whole-flush
    accumulation.  ``workload="packed"`` adds the packing axis and drops
    the ones the anchor-gather path has no use for (no decode: no kv
    dtype, no pool; monolithic prefill: no chunk)."""
    if workload not in ("full", "binary", "packed"):
        raise ValueError(f"unknown workload {workload!r}")
    from ..parallel.mesh import enumerate_mesh_shapes

    hbm = plan_mod._hbm(hbm_bytes)
    if pool_targets is None:
        pool_targets = DEFAULT_POOL_TARGETS if workload == "full" else (0,)
    if workload in ("binary", "packed"):
        # the pooled binary path has no confidence pool and prefills
        # monolithic (_prefill_select), and its pool term is byte-capped,
        # not kv-priced: its chunk, pool and kv axes collapse; the packed
        # path has no decode at all
        pool_targets = (0,)
        kv_dtypes = ("bf16",)
    packings = tuple(packings) if workload == "packed" else (1,)
    # the K axis prices the two decode legs: only the full study runs them
    decode_ks = tuple(decode_ks) if workload == "full" else (1,)
    wb = weight_bytes(cfg, quant)
    budget = hbm - plan_mod.RESERVE_BYTES - {
        "full": plan_mod.THRASH_HEADROOM_BYTES,
        "binary": BINARY_SWEEP_HEADROOM_BYTES,
        "packed": PACKED_SWEEP_HEADROOM_BYTES,
    }[workload]
    candidates: List[PlanCandidate] = []

    def add(dp, pp, tp, b, kv, chunk, pool, fits, reason, need=0, pred=0.0,
            packing=1, decode_k=1):
        candidates.append(PlanCandidate(dp, pp, tp, b, kv, chunk, pool,
                                        fits, reason, need, pred, packing,
                                        decode_k))

    for dp, pp, tp in enumerate_mesh_shapes(n_devices, max_model=max_model,
                                            max_pipe=max_pipe):
        if pp > 1:
            add(dp, pp, tp, batches[0], kv_dtypes[0], 0, 0, False,
                "pipe axis unsupported for scoring workloads "
                "(parallel/pipeline.py is train-only)")
            continue
        if cfg.num_heads % tp:
            add(dp, pp, tp, batches[0], kv_dtypes[0], 0, 0, False,
                f"num_heads {cfg.num_heads} not divisible by model axis "
                f"{tp} (padded head shards waste MXU tiles)")
            continue
        for b in batches:
            if b % (8 * dp):
                add(dp, pp, tp, b, kv_dtypes[0], 0, 0, False,
                    f"per-device batch {b}/{dp} not sublane-aligned "
                    f"(multiple of 8)")
                continue
            for kv in kv_dtypes:
                # a chunk covering the whole bucket is monolithic prefill
                for chunk in ([c for c in prefill_chunks if c < seq]
                              if workload == "full" else (0,)):
                    for pool in pool_targets:
                        for packing, dk in [
                                (p, k) for p in packings
                                for k in decode_ks]:
                            if workload == "full":
                                terms = full_study_need_terms(
                                    cfg, wb, attention_impl, b, seq,
                                    gen_tokens, score_steps, pipeline_depth,
                                    reduced_scores=True, kv_dtype=kv,
                                    prefill_chunk=chunk,
                                    pooled_confidence=True,
                                    pool_target=pool or None,
                                    decode_k=dk,
                                    slot_repack=slot_repack, quant=quant)
                            elif workload == "packed":
                                terms = plan_mod.packed_need_terms(
                                    cfg, wb, attention_impl, b,
                                    packed_seq_tokens(packing), packing,
                                    pipeline_depth, quant=quant)
                            else:
                                terms = binary_need_terms(
                                    cfg, wb, b, seq, pipeline_depth,
                                    attention_impl, quant=quant)
                            load = plan_mod.load_excess_bytes(cfg, quant,
                                                              terms)
                            if load:
                                terms["load"] = load
                            need = sharded_need_bytes(terms, cfg, dp, tp,
                                                      pp)
                            if need > budget:
                                add(dp, pp, tp, b, kv, chunk, pool, False,
                                    f"over budget: "
                                    f"{budget_reject(need, budget)} "
                                    f"per device",
                                    need, packing=packing, decode_k=dk)
                                continue
                            pred = predicted_rows_per_s(
                                cfg, dp, tp, b, kv, chunk, workload, seq,
                                packing=packing, decode_k=dk)
                            add(dp, pp, tp, b, kv, chunk, pool, True,
                                f"fits: {budget_audit(need, budget)} per "
                                f"device at dp{dp}" +
                                (f"xtp{tp}" if tp > 1 else "") +
                                (f" (Q={packing} packed)"
                                 if workload == "packed" else "") +
                                (f" (K={dk} joint decode)"
                                 if dk > 1 else ""),
                                need, pred, packing=packing, decode_k=dk)
    candidates.sort(key=lambda c: (
        not c.fits, -c.predicted_rows_per_s, c.model, c.pipe,
        c.pool_target, c.kv_dtype != "bf16", c.prefill_chunk, c.packing,
        c.decode_k, -c.batch, c.reason))
    return candidates


def chosen_plan(ranked: Sequence[PlanCandidate]) -> Optional[PlanCandidate]:
    """The winning candidate, or None when nothing fits."""
    return ranked[0] if ranked and ranked[0].fits else None


def replica_plan(cfg, quant: str, n_devices: int, workload: str = "binary",
                 seq: int = 256, attention_impl: str = "xla",
                 role: Optional[str] = None,
                 **kw) -> Optional[PlanCandidate]:
    """Per-replica operating point for the engine pool (serve/pool.py):
    search this replica's own devices and return the chosen candidate, or
    None when nothing fits.  ``role`` re-ranks the fitting candidates by
    the role-specialist rate (:func:`role_rate_factor`); the returned
    candidate carries the adjusted prediction and a ``[role=...]`` tag."""
    ranked = search_plans(cfg, quant, n_devices, seq=seq,
                          workload=workload,
                          attention_impl=attention_impl, **kw)
    if role is None:
        return chosen_plan(ranked)
    fit = [c for c in ranked if c.fits]
    if not fit:
        return None

    def adjusted(c: PlanCandidate) -> float:
        return c.predicted_rows_per_s * role_rate_factor(
            role, prefill_chunk=c.prefill_chunk, seq=seq,
            pool_target=c.pool_target, decode_k=c.decode_k)

    fit.sort(key=lambda c: (
        -adjusted(c), c.model, c.pipe, c.pool_target,
        c.kv_dtype != "bf16", c.prefill_chunk, c.packing, c.decode_k,
        -c.batch, c.reason))
    best = fit[0]
    factor = role_rate_factor(role, prefill_chunk=best.prefill_chunk,
                              seq=seq, pool_target=best.pool_target,
                              decode_k=best.decode_k)
    return dataclasses.replace(
        best, predicted_rows_per_s=adjusted(best),
        reason=f"{best.reason} [role={role} x{factor:.2f}]")


def plan_search_record(ranked: Sequence[PlanCandidate], top: int = 8,
                       rejects: int = 4) -> Dict:
    """The ``plan_search`` record: the chosen plan, the ranked runner-up
    table, a sample of rejections with reasons, and the candidate-space
    census."""
    fit = [c for c in ranked if c.fits]
    rej = [c for c in ranked if not c.fits]
    return {
        "chosen": fit[0].as_record() if fit else None,
        "runners_up": [c.as_record() for c in fit[1:1 + top]],
        "rejected_sample": [c.as_record() for c in rej[:rejects]],
        "n_candidates": len(ranked),
        "n_fit": len(fit),
        "n_rejected": len(rej),
    }


def format_candidate_table(ranked: Sequence[PlanCandidate], top: int = 8,
                           title: str = "plan search") -> str:
    """stderr table of the chosen plan and the runner-ups (one line a
    candidate, reason included): the text twin of
    :func:`plan_search_record`."""
    fit = [c for c in ranked if c.fits]
    rej = len(ranked) - len(fit)
    lines = [f"# {title}: {len(ranked)} candidates, {len(fit)} fit, "
             f"{rej} rejected"]
    for rank, c in enumerate(fit[:1 + top]):
        tag = "chosen " if rank == 0 else f"rank {rank + 1:2d}"
        lines.append(
            f"#   {tag}: mesh dp{c.data}xpp{c.pipe}xtp{c.model} "
            f"batch {c.batch} kv {c.kv_dtype} chunk {c.prefill_chunk} "
            f"pool {c.pool_target or 'batch'}"
            + (f" packing {c.packing}" if c.packing > 1 else "")
            + (f" decode-k {c.decode_k}" if c.decode_k > 1 else "")
            + f" -> {c.predicted_rows_per_s:.1f} rows/s ({c.reason})")
    if not fit:
        lines.append("#   NO candidate fits the budget; first reject: "
                     + (ranked[0].reason if ranked else "(empty space)"))
    return "\n".join(lines)


def require_ranks(best: PlanCandidate, world: int) -> None:
    """Raise for a chosen plan whose mesh needs more ranks than the world
    has (``world``: the process group's size, 1 without one)."""
    need = best.data * best.pipe * best.model
    if need > world:
        raise ValueError(
            f"the chosen plan's mesh dp{best.data}xpp{best.pipe}"
            f"xtp{best.model} needs {need} ranks; the world has {world} "
            f"(launch one process a rank, as torchrun --nproc-per-node "
            f"{need} does)")


# ---------------------------------------------------------------------------
# Dryrun leg: eight devices' prediction against the hand-picked mesh
# ---------------------------------------------------------------------------

def _flagship_small_config():
    """The test-scale Falcon-architecture geometry the dryrun prices."""
    from ..models.config import FLAGSHIP_SMALL_GEOMETRY, DecoderConfig

    return DecoderConfig(**FLAGSHIP_SMALL_GEOMETRY)


def run_dryrun(n_devices: int = 8, exec_leg: bool = True, out=None,
               hbm_bytes: Optional[int] = None) -> Dict:
    """Search ``n_devices`` devices (arithmetic only: no device is
    touched) and show the chosen plan reproduces or beats the hand-picked
    dp x tp operating point; then (``exec_leg``) build the chosen mesh and
    score on it with single-device parity (:func:`_exec_tiny_leg`)."""
    out = out or sys.stderr
    hand_n = (HAND_PICKED_MULTICHIP["data"] * HAND_PICKED_MULTICHIP["pipe"]
              * HAND_PICKED_MULTICHIP["model"])
    if n_devices != hand_n:
        raise ValueError(
            f"the dryrun compares against the hand-picked mesh "
            f"{HAND_PICKED_MULTICHIP}, which factorizes exactly "
            f"{hand_n} devices; got n_devices={n_devices}")
    cfg = _flagship_small_config()
    ranked = search_plans(cfg, "int8", n_devices, seq=96, workload="binary",
                          batches=tuple(range(32, 513, 32)),
                          hbm_bytes=hbm_bytes)
    best = chosen_plan(ranked)
    if best is None:
        raise RuntimeError("dryrun: no candidate fits the tiny geometry")
    hand = [c for c in ranked
            if c.fits and c.mesh_shape == HAND_PICKED_MULTICHIP
            and c.batch == best.batch]
    if not hand:
        raise RuntimeError(
            f"hand-picked mesh {HAND_PICKED_MULTICHIP} missing from the "
            f"candidate table at batch {best.batch}")
    hand_best = hand[0]
    if best.predicted_rows_per_s < hand_best.predicted_rows_per_s:
        raise RuntimeError(
            f"search lost to the hand-picked mesh: {best} vs {hand_best}")
    print(format_candidate_table(ranked, title="plan search dryrun"),
          file=out)
    result = {"chosen": best.as_record(),
              "hand_picked": hand_best.as_record(),
              "n_devices": n_devices}
    if exec_leg:
        result["exec"] = _exec_tiny_leg(cfg, best, out)
    print(
        f"plan search dryrun OK: chose mesh dp{best.data}xpp{best.pipe}"
        f"xtp{best.model} batch {best.batch} "
        f"({best.predicted_rows_per_s:.1f} predicted rows/s) vs "
        f"hand-picked dp4xtp2 "
        f"({hand_best.predicted_rows_per_s:.1f}) on {n_devices} devices"
        + (", exec checked" if exec_leg else ""), file=out)
    return result


def _exec_tiny_leg(cfg, best: PlanCandidate, out) -> Dict:
    """Build the chosen mesh and score a handful of prompts through the
    sharded engine with single-device parity: proof the plan runs.  The
    counterpart of the reference's eight virtual CPU devices is a world of
    gloo ranks on the CPU, one spawned process a device of the plan, met
    through a ``file://`` rendezvous in a temporary directory; rank 0
    reports."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    world = best.data * best.pipe * best.model
    shape = dict(data=best.data, pipe=best.pipe, model=best.model)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_exec_rank, args=(world, tmp, cfg, shape),
                           nprocs=world, start_method="spawn")
        with open(os.path.join(tmp, "exec.pkl"), "rb") as f:
            result = pickle.load(f)
    print(f"# plan search exec: sharded fast-path parity on "
          f"mesh {result['mesh']} ({result['prompts']} prompts, "
          f"{world} gloo ranks)", file=out)
    return result


def _exec_rank(rank: int, world: int, tmp: str, cfg, shape: Dict) -> None:
    """One rank of :func:`_exec_tiny_leg`: the reference's tiny w8a8 model
    (numpy seed 0), its first-token relative probabilities on one device
    and on the mesh, held to the reference's tolerance (atol 5e-5, rtol
    1e-4)."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    from ..models.convert import params_from_jax
    from ..ops.quant import quantize_decoder_params_np
    from ..parallel import initialize_distributed, make_mesh
    from ..parallel.mesh import AXES
    from ..utils.tokenizer import WordTokenizer
    from .engine import EngineConfig, ScoringEngine

    torch.set_num_threads(1)
    initialize_distributed(num_processes=world, process_id=rank,
                           device="cpu", init_method=f"file://{tmp}/store",
                           timeout=120)
    try:
        mesh = make_mesh(**shape)
        rng = np.random.default_rng(0)
        h, nd = cfg.hidden_size, cfg.num_heads * cfg.head_dim
        kvd = cfg.num_kv_heads * cfg.head_dim
        L, F, V = cfg.num_layers, cfg.intermediate_size, cfg.vocab_size

        def init(*s):
            return (rng.standard_normal(s) * 0.02).astype(np.float32)

        params = quantize_decoder_params_np({
            "embed": {"tokens": init(V, h)},
            "layers": {
                "ln1": {"scale": np.ones((L, h), np.float32),
                        "bias": np.zeros((L, h), np.float32)},
                "attn": {"wq": init(L, h, nd), "wk": init(L, h, kvd),
                         "wv": init(L, h, kvd), "wo": init(L, nd, h)},
                "mlp": {"wi": init(L, h, F), "wo": init(L, F, h)},
            },
            "final_ln": {"scale": np.ones(h, np.float32),
                         "bias": np.zeros(h, np.float32)},
        })
        tokenizer = WordTokenizer(["Question:", "is", "candidate", "a",
                                   "plan?", "Answer:"]
                                  + [str(i) for i in range(4)])
        prompts = [f"Question: is candidate {i} a plan? Answer:"
                   for i in range(4)]
        dp = shape["data"]
        ecfg = EngineConfig(batch_size=dp * max(1, -(-4 // dp)),
                            decode_completions=False, buckets=(32, 96))
        single = ScoringEngine(
            "falcon", cfg, params_from_jax(params, cfg, device="cpu",
                                           dtype="fp32"),
            tokenizer, engine_config=ecfg, device="cpu")
        sharded = ScoringEngine(
            "falcon", cfg, params_from_jax(params, cfg, device="cpu",
                                           dtype="fp32"),
            tokenizer, engine_config=ecfg, device="cpu").bind_mesh(mesh)
        ref = single.first_token_relative_prob(prompts)
        got = sharded.first_token_relative_prob(prompts)
        np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-4)
        if rank == 0:
            with open(os.path.join(tmp, "exec.pkl"), "wb") as f:
                pickle.dump({"mesh": dict(zip(AXES, mesh.mesh.shape)),
                             "prompts": len(prompts), "parity": True}, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# CLI: ``python -m llm_interpretation_replication_tpu_torch plan search``
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="llm_interpretation_replication_tpu_torch plan",
        description="plan search over mesh x batch x kv-dtype x "
                    "prefill-chunk x pool target")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("search", help="enumerate + rank candidate plans")
    p.add_argument("--model", choices=["falcon-7b", "small-1b"],
                   default="falcon-7b", help="bench geometry to price")
    p.add_argument("--quant", choices=["none", "int8"], default="int8")
    p.add_argument("--devices", type=int, default=1, metavar="N",
                   help="device count to enumerate meshes over (the search "
                        "is host arithmetic)")
    p.add_argument("--seq", type=int, default=256,
                   help="worst-bucket sequence length to budget")
    p.add_argument("--workload", choices=["full", "binary", "packed"],
                   default="full",
                   help="full: the two-leg full-study row; binary: the "
                        "yes/no pooled look-ahead sweep; packed: "
                        "anchor-gathered multi-question prompting "
                        "(questions/s, adds the packing axis)")
    p.add_argument("--attention-impl", choices=["xla", "flash"],
                   default="xla",
                   help="the prompt forward's route to price: dense "
                        "('xla') or the causal kernel ('flash')")
    p.add_argument("--batch-max", type=int, default=512)
    p.add_argument("--pipeline-depth", type=int, default=None,
                   help="in-flight device batches to budget (default: 2 "
                        "for the full-study workload, 4 for the others)")
    p.add_argument("--hbm-gib", type=float, default=None,
                   help="per-device memory in GiB (default: the card's; "
                        "needed without a card)")
    p.add_argument("--top", type=int, default=8,
                   help="runner-ups to print/record")
    p.add_argument("--format", choices=["table", "json"], default="table")
    p.add_argument("--dryrun", action="store_true",
                   help="search 8 devices (tiny flagship geometry) and "
                        "prove the choice reproduces or beats the "
                        "hand-picked dp4xtp2 point")
    p.add_argument("--exec", dest="exec_leg",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="with --dryrun: also build the chosen mesh on "
                        "spawned gloo ranks of the CPU and score on it "
                        "with single-device parity (--no-exec = "
                        "prediction comparison only)")
    args = parser.parse_args(argv)
    hbm = None if args.hbm_gib is None else int(args.hbm_gib * 2**30)

    if args.dryrun:
        if args.devices not in (1, 8):
            parser.error(f"--dryrun searches 8 devices; drop --devices "
                         f"{args.devices} or pass 8")
        result = run_dryrun(n_devices=8, exec_leg=args.exec_leg,
                            hbm_bytes=hbm)
        if args.format == "json":
            print(json.dumps(result))
        return 0

    from ..models.config import BENCH_GEOMETRIES, DecoderConfig

    cfg = DecoderConfig(**BENCH_GEOMETRIES[args.model])
    ranked = search_plans(
        cfg, args.quant, args.devices, seq=args.seq,
        workload=args.workload,
        batches=tuple(range(32, args.batch_max + 1, 32)),
        pipeline_depth=args.pipeline_depth
        or (2 if args.workload == "full" else 4),
        hbm_bytes=hbm, attention_impl=args.attention_impl)
    if args.format == "json":
        print(json.dumps(plan_search_record(ranked, top=args.top)))
    else:
        print(format_candidate_table(ranked, top=args.top))
    return 0 if chosen_plan(ranked) is not None else 1


if __name__ == "__main__":
    raise SystemExit(main())
