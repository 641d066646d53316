"""Compatibility keys: which requests may share one micro-batch (the JAX
package's ``serve/coalescer.py`` on the port's ``runtime/batching`` and
``runtime/plan``).

Two requests coalesce only when the engine would run them through the
SAME warm compiled-program family — that is exactly the
``GenerationPlan`` cache key (runtime/plan.plan_cache_key: the per-call
``max_new_tokens`` cap and ``with_confidence`` change the generation
schedule, so mixing them would force one call's plan on the other's
rows), the same scoring path (plain vs fused prefix+suffix), and the
same length bucket (runtime/batching bucket menu — the shape the
bucketed prefill programs compile for).  Targets are NOT part of the key:
the engine broadcasts per-row (yes, no) token-id operands, so mixed
scenarios batch together (the cross-scenario batching win).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from ..runtime import batching
from ..runtime.plan import plan_cache_key
from .request import ScoreRequest

#: key kinds
PLAIN = "plain"
PREFIXED = "prefixed"


def encode_request(engine, req: ScoreRequest) -> Any:
    """Pre-tokenize on the SUBMIT thread (host work stays off the
    scheduler loop): a plain prompt becomes a token-id list; a
    ``(prefix, suffix)`` pair becomes ``(prefix_ids, suffix_ids)``
    (prefix with special tokens, suffix without — the fused-path
    contract).  Engines without a tokenizer (test fakes, remote shims)
    get ``None`` and receive the raw strings."""
    tok = getattr(engine, "tokenizer", None)
    if tok is None:
        return None
    if req.prefix is not None:
        pe, se = batching.encode_prefix_pairs(tok, [(req.prefix,
                                                     (req.suffix,))])
        return pe[0], se[0][0]
    return batching.encode_prompts(tok, [req.prompt])[0]


def _bucket_of(engine, length: Optional[int]) -> Any:
    if length is None:
        return None
    ecfg = getattr(engine, "ecfg", None)
    buckets = ecfg.buckets if ecfg is not None else batching.DEFAULT_BUCKETS
    try:
        return batching.bucket_for(length, buckets)
    except ValueError:
        return "overflow"  # longer than the largest bucket: own group


def compat_key(engine, req: ScoreRequest, encoded: Any) -> Tuple:
    """The micro-batch compatibility key for one request.

    ``decode_k`` is part of the key: the joint K-token decode
    consumes chunks in K-sized verification blocks, so two requests
    resolving to DIFFERENT K would force one request's block schedule on
    the other's rows — mixed-K requests must never share an engine call.
    A request's ``decode_k=None`` resolves to the engine's configured
    value, so plain traffic on a K-configured engine still coalesces."""
    ecfg = getattr(engine, "ecfg", None)
    if ecfg is not None:
        plan_part = plan_cache_key(
            ecfg.score_steps, ecfg.max_look_ahead, ecfg.max_new_tokens,
            ecfg.decode_completions, req.max_new_tokens)
    else:
        plan_part = (req.max_new_tokens,)
    engine_k = int(getattr(ecfg, "decode_k", 1) or 1) if ecfg is not None \
        else 1
    decode_k = int(req.decode_k) if req.decode_k is not None else engine_k
    if req.prefix is not None:
        length = len(encoded[0]) if encoded is not None else None
        kind = PREFIXED
    else:
        length = len(encoded) if encoded is not None else None
        kind = PLAIN
    return (kind, _bucket_of(engine, length), bool(req.with_confidence),
            req.max_new_tokens, decode_k, plan_part)
