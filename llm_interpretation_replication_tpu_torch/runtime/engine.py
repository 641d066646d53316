"""ScoringEngine for the port: binary-leg yes/no scoring, batch by batch.

Port of ``runtime/engine.py``'s per-batch route of ``score_prompts`` under
``EngineConfig(decode_completions=False, phase2_pool=False)``:

1. prompt prefill (``models.decoder.prefill``; its attention is the Hopper
   kernel when ``attention_impl`` selects flash);
2. the position-0 top-k scan (``scoring.yes_no.first_token_scan``) and the
   top-20-filtered position-0 probabilities;
3. a scored greedy look-ahead over only the undecided rows, gathered out of
   the prefill cache (menu-padded), in ``scan_chunk``-step chunks that stop
   once every real row is resolved;
4. the yes/no scan over the look-ahead's ``ReducedScores``.

Batches run one after another.  Every ``EngineConfig`` field keeps the
reference's name and default; a setting this slice cannot honour raises
``NotImplementedError`` naming the ROADMAP.md item that will bring it.  A
device out-of-memory error propagates (the reference's OOM back-off ladder
comes with pipelining).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DEFAULT_BUCKETS
from ..device import DEFAULT_DEVICE, resolve_device
from ..models import decoder as dmod
from ..scoring import yes_no as yn
from . import batching
from . import plan as plan_mod

_ITEM_POOL = "ROADMAP.md queue 1, '_Phase2Pool and the slot ring'"
_ITEM_FULL = "ROADMAP.md queue 1, 'The full-study legs'"
_ITEM_KDEC = "ROADMAP.md queue 1, 'K-decode'"
_ITEM_T5 = "ROADMAP.md queue 1, 'T5'"
_ITEM_PAR = "ROADMAP.md queue 1, 'Parallel and training'"
_ITEM_OOM = "ROADMAP.md queue 1, 'Pipelining and the OOM ladder'"


class EngineClosed(RuntimeError):
    """Scoring was attempted on a closed :class:`ScoringEngine`."""


@dataclasses.dataclass
class EngineConfig:
    """The reference's engine knobs, same names and defaults.  This slice
    honours the binary per-batch route: ``decode_completions=False`` and
    ``phase2_pool=False`` are required; the knobs of the paths not ported
    yet (``prefill_chunk``, ``decode_k``) must keep their defaults.
    ``kv_dtype`` ("bf16" or "int8") sets the decoder's ``kv_cache_dtype``
    at construction, as in the reference.  ``pipeline_depth`` does not
    change results; batches run one at a time here.  ``oom_backoff`` is not honoured yet: a device
    out-of-memory error propagates; a non-default ``oom_batch_floor`` or
    ``oom_batch_ladder`` raises until the ladder is ported."""
    batch_size: int = 32
    max_new_tokens: int = 50
    score_steps: int = 10           # MAX_LOOK_AHEAD -- steps that need scores
    max_look_ahead: int = 10
    scan_chunk: int = 5             # scored-decode chunk; early exit between
    top_k: int = 5
    first_token_top_filter: int = 20
    buckets: Sequence[int] = DEFAULT_BUCKETS
    length_sorted_batches: bool = True
    decode_completions: bool = True
    completion_chars: int = 100
    pipeline_depth: int = 2
    phase2_pool: bool = True
    phase2_pool_target: int = 0
    phase2_select_slice: int = 0
    phase2_pool_max_bytes: int = 512 << 20
    pooled_confidence: bool = True
    slot_repack: bool = True
    kv_dtype: str = "bf16"
    decode_k: int = 1
    prefill_chunk: int = 0
    oom_backoff: bool = True
    oom_batch_floor: int = 8
    oom_batch_ladder: Sequence[int] = ()


def _check_supported(family, ecfg: EngineConfig, mesh) -> None:
    """Raise NotImplementedError for every setting this slice cannot honour."""
    if ecfg.kv_dtype not in ("bf16", "int8"):
        raise ValueError(f"unknown kv_dtype {ecfg.kv_dtype!r}")
    unsupported = [
        (family == "t5", "encoder-decoder models", _ITEM_T5),
        (mesh is not None, "a device mesh", _ITEM_PAR),
        (ecfg.decode_completions, "decode_completions=True", _ITEM_FULL),
        (ecfg.phase2_pool, "phase2_pool=True (with or without slot_repack)",
         _ITEM_POOL),
        (int(ecfg.prefill_chunk or 0) > 0, "prefill_chunk > 0", _ITEM_FULL),
        (int(ecfg.decode_k) > 1, "decode_k > 1", _ITEM_KDEC),
        (bool(ecfg.oom_batch_ladder) or ecfg.oom_batch_floor != 8,
         "an OOM batch ladder or floor", _ITEM_OOM),
    ]
    for bad, what, item in unsupported:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet ({item})")


class ScoringEngine:
    """Holds (family, model config, weights, tokenizer) and scores prompts
    on ``device`` (default ``"cuda"``).  The tokenizer is any object with
    ``__call__``, ``encode``, ``decode``, ``pad_token_id`` and
    ``eos_token_id`` (a Hugging Face tokenizer, or ``utils.tokenizer``).
    Weights may be w8a8 int8 (``{key}_qscale`` beside a projection)."""

    def __init__(self, family, cfg, params: dmod.DecoderWeights, tokenizer,
                 mesh=None, engine_config: Optional[EngineConfig] = None,
                 device=DEFAULT_DEVICE):
        ecfg = engine_config or EngineConfig()
        _check_supported(family, ecfg, mesh)
        # the KV storage dtype lives on the decoder config: resolve the
        # engine knob into it once, at construction
        if ecfg.kv_dtype != "bf16" and cfg.kv_cache_dtype != ecfg.kv_dtype:
            cfg = dataclasses.replace(cfg, kv_cache_dtype=ecfg.kv_dtype)
        self.family = family
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.tokenizer = tokenizer
        self.mesh = mesh
        self.ecfg = ecfg
        self._plan_cache: Dict[Tuple, plan_mod.GenerationPlan] = {}
        self._closed = False

    # -- lifecycle -------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    def _check_open(self) -> None:
        if self._closed:
            raise EngineClosed(
                "ScoringEngine is closed -- its weights are released; "
                "construct a new engine before scoring")

    def close(self) -> None:
        """Drop the engine's reference to its weights and return cached
        device memory to the driver.  The caller's ``DecoderWeights`` stay
        usable by other engines; their memory is freed once no one holds
        them.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.params = None
        self._plan_cache.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def __enter__(self) -> "ScoringEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- helpers ---------------------------------------------------------

    def target_ids(self, targets: Sequence[str]) -> List[int]:
        return yn.target_token_ids(self.tokenizer, targets, False)

    def _target_id_rows(self, prompts, targets) -> np.ndarray:
        """``targets`` -> per-prompt [(yes_id, no_id)]: one (yes, no) string
        pair for every prompt, or one pair per prompt."""
        if targets and not isinstance(targets[0], str):
            if len(targets) != len(prompts):
                raise ValueError(
                    f"per-prompt targets: got {len(targets)} pairs for "
                    f"{len(prompts)} prompts")
            cache: Dict[tuple, tuple] = {}
            rows = np.empty((len(prompts), 2), np.int32)
            for i, pair in enumerate(targets):
                key = tuple(pair)
                if key not in cache:
                    cache[key] = tuple(self.target_ids(list(pair))[:2])
                rows[i] = cache[key]
            return rows
        yes_id, no_id = self.target_ids(list(targets))[:2]
        return np.tile(np.asarray([[yes_id, no_id]], np.int32),
                       (len(prompts), 1))

    @staticmethod
    def _batch_target_rows(ids_all: np.ndarray, batch) -> np.ndarray:
        """[B, 2] target ids for one batch; pad rows take row 0's ids."""
        first = int(batch.indices[0])
        idx = np.where(batch.indices >= 0, batch.indices, first)
        return ids_all[idx]

    def _gen_plan(self, max_new_tokens: Optional[int] = None
                  ) -> plan_mod.GenerationPlan:
        ecfg = self.ecfg
        key = plan_mod.plan_cache_key(
            ecfg.score_steps, ecfg.max_look_ahead, ecfg.max_new_tokens,
            ecfg.decode_completions, max_new_tokens)
        plan = self._plan_cache.get(key)
        if plan is None:
            plan = self._plan_cache[key] = plan_mod.generation_plan(
                ecfg.score_steps, ecfg.max_look_ahead, ecfg.max_new_tokens,
                ecfg.decode_completions, max_new_tokens)
        return plan

    def _tensor(self, arr, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), device=self.device, dtype=dtype)

    # -- core ------------------------------------------------------------

    def score_prompts(
        self,
        prompts: Sequence,
        targets: Sequence = ("Yes", "No"),
        with_confidence: bool = False,
        max_new_tokens: Optional[int] = None,
    ) -> List[Dict]:
        """Yes/No scoring: one dict per prompt with yes_prob, no_prob,
        relative_prob, odds_ratio, scan_found, completion (empty on this
        route), success and the first_token_{yes,no,relative}_prob fields.
        Prompts are strings or pre-tokenized id sequences."""
        self._check_open()
        _check_supported(self.family, self.ecfg, self.mesh)
        if with_confidence:
            raise NotImplementedError(
                f"with_confidence is not ported yet ({_ITEM_FULL})")
        if prompts and _is_prefix_pair(prompts[0]):
            raise NotImplementedError(
                f"(prefix, suffix) prompts (score_prefixed) are not ported "
                f"yet ({_ITEM_FULL})")
        ecfg = self.ecfg
        ids_all = self._target_id_rows(prompts, targets)   # [N, 2]
        eos_id = getattr(self.tokenizer, "eos_token_id", None)
        encoded = batching.encode_prompts(self.tokenizer, prompts)
        results: List[Optional[Dict]] = [None] * len(prompts)
        steps, _ = self._gen_plan(max_new_tokens)
        for batch in batching.batches_for_prompts(
                encoded, ecfg.batch_size, ecfg.buckets,
                pad_id=self.tokenizer.pad_token_id or 0,
                length_sorted=ecfg.length_sorted_batches):
            out = self._launch(batch, ids_all)
            self._consume_scored_batch(batch, out, ids_all, results, steps,
                                       eos_id)
        return [r if r is not None else _error_row("missing") for r in results]

    def _launch(self, batch, ids_all):
        """Prefill one batch and run the position-0 scans on the device."""
        ecfg = self.ecfg
        ids = self._tensor(batch.token_ids, torch.int64)
        mask = self._tensor(batch.attention_mask, torch.int32)
        # cache_len == bucket length: decode folds its tails in per chunk
        last, cache = dmod.prefill(self.params, self.cfg, ids, mask,
                                   cache_len=batch.bucket_len)
        lengths = mask.sum(-1)
        row_ids = self._tensor(self._batch_target_rows(ids_all, batch),
                               torch.int64)
        scan0 = yn.first_token_scan(last, row_ids[:, 0], row_ids[:, 1],
                                    top_k=ecfg.top_k)
        first3 = yn.relative_prob_first_token(
            last, row_ids[:, 0], row_ids[:, 1], ecfg.first_token_top_filter)
        return last, cache, lengths, scan0, first3

    def _consume_scored_batch(self, batch, out, ids_all, results, steps,
                              eos_id):
        """One batch into ``results``: rows whose position-0 top-k holds a
        target keep the position-0 read; the undecided rows go through the
        scored look-ahead.  Keyed by prompt index."""
        last, cache, lengths, scan0, first3 = out
        yes0, no0, rel0, odds0, hit0 = (t.cpu().numpy() for t in scan0)
        first3 = tuple(t.cpu().numpy() for t in first3)
        row_ids = self._batch_target_rows(ids_all, batch)
        valid = batch.indices >= 0
        undecided = np.flatnonzero(~hit0 & valid)
        res_np = None
        sub_pos = None        # batch row -> row in the subset arrays
        if undecided.size > 0:
            m = _pad_slice(undecided.size, hit0.shape[0])
            if m == hit0.shape[0]:
                sub_cache, last_s, len_s = cache, last, lengths
                real, ids_sub = valid, row_ids
            else:
                idx = np.zeros((m,), np.int64)
                idx[: undecided.size] = undecided
                sub_cache, last_s, len_s = _gather_rows(
                    cache, last, lengths, self._tensor(idx))
                sub_pos = {int(r): j for j, r in enumerate(undecided)}
                real = np.zeros((m,), bool)
                real[: undecided.size] = True
                ids_sub = row_ids[idx]
            sc, toks_s = self._scan_decode_chunked(
                sub_cache, last_s, len_s, steps, eos_id,
                ids_sub[:, 0], ids_sub[:, 1], real_mask=real)
            res = self._scan_results(sc, ids_sub[:, 0], ids_sub[:, 1],
                                     toks_s, eos_id)
            res_np = {k: v.cpu().numpy() for k, v in res._asdict().items()}

        for r, orig in enumerate(batch.indices):
            if orig < 0:
                continue
            if hit0[r]:
                vals = (yes0[r], no0[r], rel0[r], odds0[r], True)
            else:
                j = r if sub_pos is None else sub_pos[r]
                vals = (res_np["yes_prob"][j], res_np["no_prob"][j],
                        res_np["relative_prob"][j], res_np["odds_ratio"][j],
                        res_np["found"][j])
            results[int(orig)] = _attach_first_token(_result_row(*vals, ""),
                                                     first3, r)

    def _scan_results(self, sc, yes_ids, no_ids, toks, eos_id):
        """Yes/no scan over a chunked decode's scores (full [m, P, V] scores
        or ReducedScores, whichever the decode produced)."""
        vsteps = yn.steps_until_eos(toks, eos_id)
        if isinstance(sc, dmod.ReducedScores):
            return yn.yes_no_from_reduced(
                sc.topk_vals, sc.logz, sc.target_logits,
                max_look_ahead=self.ecfg.max_look_ahead,
                top_k=self.ecfg.top_k, valid_steps=vsteps)
        return yn.yes_no_from_scores(
            sc, self._tensor(yes_ids), self._tensor(no_ids),
            max_look_ahead=self.ecfg.max_look_ahead, top_k=self.ecfg.top_k,
            valid_steps=vsteps)

    def _scan_decode_chunked(self, sub_cache, last_s, len_s, steps, eos_id,
                             yes_id, no_id,
                             real_mask: Optional[np.ndarray] = None):
        """Scored look-ahead decode in ``scan_chunk``-step chunks with early
        exit once every real row has a top-k hit or has emitted EOS (no later
        position can change its scan).  Returns (scores, tokens [m, P]),
        P <= steps; scores are ReducedScores unless ``top_k`` exceeds the
        kept candidates."""
        ecfg = self.ecfg
        chunk = max(1, ecfg.scan_chunk)
        reduced = ecfg.top_k <= dmod.REDUCED_TOPK
        target_ids = None
        if reduced:
            target_ids = self._tensor(
                np.stack([yes_id, no_id], axis=1), torch.int64)
        return self._scan_decode_loop(
            sub_cache, last_s, len_s, steps, eos_id, real_mask,
            chunk, reduced, target_ids, yes_id, no_id)

    def _scan_decode_loop(self, sub_cache, last_s, len_s, steps, eos_id,
                          real_mask, chunk, reduced, target_ids,
                          yes_id, no_id):
        ecfg = self.ecfg
        sc_parts, tok_parts = [], []
        cur_cache, prev, done = sub_cache, last_s, None
        offset = 0
        while offset < steps:
            n = min(chunk, steps - offset)
            toks_c, sc_c, cur_cache, prev, done = dmod.decode_steps(
                self.params, self.cfg, cur_cache, prev, len_s, offset, n,
                eos_id, done, with_scores="reduced" if reduced else True,
                target_ids=target_ids)
            sc_parts.append(sc_c)
            tok_parts.append(toks_c)
            offset += n
            if offset >= steps:
                break
            toks_sofar = torch.cat(tok_parts, dim=1)
            vsteps = yn.steps_until_eos(toks_sofar, eos_id)
            if reduced:
                sofar = _cat_scores(sc_parts, True)
                part = yn.yes_no_from_reduced(
                    sofar.topk_vals, sofar.logz, sofar.target_logits,
                    max_look_ahead=offset, top_k=ecfg.top_k,
                    valid_steps=vsteps)
            else:
                part = yn.yes_no_from_scores(
                    torch.cat(sc_parts, dim=1), self._tensor(yes_id),
                    self._tensor(no_id), max_look_ahead=offset,
                    top_k=ecfg.top_k, valid_steps=vsteps)
            # resolved = scan hit so far, or EOS actually emitted
            resolved = (part.found | done).cpu().numpy()
            if real_mask is not None:
                resolved = resolved[real_mask]
            if bool(resolved.all()):
                break
        return _cat_scores(sc_parts, reduced), torch.cat(tok_parts, dim=1)


def _is_prefix_pair(prompt) -> bool:
    """A ``(prefix, suffix)`` 2-tuple asks for the fused prefix-reuse path;
    pre-tokenized prompts are lists/arrays of ints."""
    return (isinstance(prompt, tuple) and len(prompt) == 2
            and not isinstance(prompt[0], (int, np.integer)))


def _cat_scores(parts, reduced: bool):
    """Concatenate per-chunk score pieces along the step axis."""
    if not reduced:
        return torch.cat(parts, dim=1)
    return dmod.ReducedScores(*(
        torch.cat([getattr(p, f) for p in parts], dim=1)
        for f in dmod.ReducedScores._fields))


#: Menu of look-ahead slice sizes (each power of two gets a 1.5x midpoint,
#: so a padded slice wastes at most ~33% of its rows).
_SLICE_MENU = (8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)


def _pad_slice(n: int, cap: int) -> int:
    """Smallest menu size >= n, capped at the batch size."""
    for m in _SLICE_MENU:
        if m >= n:
            return min(m, cap)
    return cap


def _gather_rows(cache: dmod.KVCache, last, lengths, idx):
    """The look-ahead subset's rows of the prefill outputs: cache k/v (and
    an int8 cache's scales) are [L, B, T, ...] (batch axis 1); everything
    else is batch-leading."""
    sub = dmod.cache_kv_map(cache, lambda t: t[:, idx],
                            positions=cache.positions[idx],
                            valid=cache.valid[idx])
    return sub, last[idx], lengths[idx]


def _attach_first_token(row: Dict, first3, i: int) -> Dict:
    """Attach the top-filtered position-0 probabilities."""
    row["first_token_yes_prob"] = float(first3[0][i])
    row["first_token_no_prob"] = float(first3[1][i])
    row["first_token_relative_prob"] = float(first3[2][i])
    return row


def _result_row(yes, no, rel, odds, found, completion: str) -> Dict:
    """One prompt's result dict (the ``get_yes_no_logprobs`` contract)."""
    return {
        "yes_prob": float(yes),
        "no_prob": float(no),
        "relative_prob": float(rel),
        "odds_ratio": float(odds),
        "scan_found": bool(found),
        "completion": completion,
        "success": True,
    }


def _error_row(msg: str) -> Dict:
    return {
        "yes_prob": float("nan"),
        "no_prob": float("nan"),
        "relative_prob": float("nan"),
        "odds_ratio": float("nan"),
        "scan_found": False,
        "completion": f"ERROR: {msg[:50]}",
        "success": False,
    }
