"""ScoringEngine for the port: yes/no scoring, completions and the
verbalized-confidence leg.

Port of ``runtime/engine.py``'s ``score_prompts`` and ``score_prefixed``
with every ``EngineConfig`` field at the reference's default or any value
the port honours:

1. prompt prefill (``models.decoder.prefill``; its attention is the Hopper
   kernel when ``attention_impl`` selects flash) and the position-0 top-k
   scan with the top-20-filtered position-0 probabilities;
2. a scored greedy look-ahead over only the undecided rows, and the yes/no
   scan over its ``ReducedScores``;
3. with ``decode_completions`` (the default), every row greedy-generates
   its completion in ``scan_steps`` chunks up to ``max_new_tokens`` (the
   first chunk doubles as the scored look-ahead), stopping early, one chunk
   late, once every row has emitted EOS;
4. with ``with_confidence``, every row takes the scored decode and its
   first three positions' top-19 candidates feed
   ``scoring.confidence.weighted_confidence_digits``.

``first_token_relative_prob`` reads only the position-0 probabilities, one
forward a batch.  ``score_packed`` scores packed rows of several questions
(``scoring.packed``) from the logits gathered at each question's anchor in
one prefill (``models.decoder.forward_anchor_logits``), decoding nothing;
``packed_autoregressive_demos`` decodes each packed question's
demonstration on the slot ring, stage by stage.

With ``decode_k > 1`` and a K-head (:meth:`ScoringEngine.distill_k_head_on`,
or ``runtime.loader.attach_k_head``), the completion chunks, the pooled
confidence flushes and the slot ring decode each chunk in joint K-token
verify passes (:meth:`ScoringEngine._k_decode_chunk` over
``models.decoder.k_verify_block``); a rejected pass re-runs the chunk
sequentially, so rows are those of ``decode_k=1``.

A T5 encoder-decoder (family ``"t5"``, ``models.t5``) scores per batch
through one greedy decode (``_score_encdec``): the decoder re-runs its short
prefix each step, the scan reads the first ``max_look_ahead`` steps, and
the completion is the whole decode; ``score_prefixed`` scores each leg over
the joined token streams.  The decoder-only entries (slotted scoring, KV
slabs) refuse it, as in the reference.  A prompt bucket longer than ``prefill_chunk`` (when set)
prefills in chunks (``models.decoder.chunked_prefill``).

``score_prefixed`` (and ``(prefix, suffix)`` prompts) prefill each batch's
shared prefixes once and run every leg (:class:`LegSpec`) as a
suffix-extension prefill (``models.decoder.extend_prefill``) against that
cache; :class:`PrefixCachePool` audits the prefix caches' lifetimes.

Two routes run the binary leg's step 2 without completions.
``phase2_pool=True`` (the default):
:func:`_prefill_select` keeps only an undecided-first slice of each batch's
cache, and :class:`_Phase2Pool` gathers the undecided rows of many batches
and decodes them together, through a ``runtime.slots.SlotRing`` whose
retired lanes refill between chunks (``slot_repack=True``, the default) or
in whole flushes of ``phase2_pool_target`` rows (``slot_repack=False``); a
batch with more undecided rows than the slice holds re-runs its prefill and
decodes in place.  ``phase2_pool=False``: each batch decodes its own
undecided rows, gathered out of its prefill cache.  A confidence leg whose
decode cap fits inside the scored scan pools every row the same way
(``pooled_confidence=True``, the default; :class:`_Phase2Pool` with
``confidence=True``), where a row retires as soon as its completion's first
integer can no longer change (``scoring.confidence.first_int_stable``);
completions, and a confidence leg with ``pooled_confidence=False``, decode
per batch.

Every route runs through :meth:`ScoringEngine._run_pipelined`: up to
``pipeline_depth`` batches are launched before the oldest is consumed, and
a batch whose launch or consume runs out of device memory is retried at the
next size down the OOM ladder (``oom_backoff``, ``oom_batch_ladder``,
``oom_batch_floor``; each step lands in ``fault_events``).  The slot ring
also serves :meth:`ScoringEngine.score_prompts_slotted` (mid-decode
admission) and the KV-slab handoff (:meth:`~ScoringEngine.export_kv_slab`,
:meth:`~ScoringEngine.decode_kv_slabs`).

Every ``EngineConfig`` field keeps the reference's name and default; a
setting the port cannot honour yet raises ``NotImplementedError`` naming the
ROADMAP.md item that will bring it.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DEFAULT_BUCKETS
from ..device import DEFAULT_DEVICE, resolve_device
from ..models import decoder as dmod
from ..models import t5 as t5mod
from ..scoring import confidence as conf_mod
from ..scoring import yes_no as yn
from ..utils.telemetry import record_counter, record_fault, record_hist
from . import batching, faults
from . import plan as plan_mod
from . import slots as slots_mod

_ITEM_PAR = "ROADMAP.md queue 1, 'Parallel and training'"


class EngineClosed(RuntimeError):
    """Scoring was attempted on a closed :class:`ScoringEngine`."""


@torch.no_grad()
def _confidence_topk(scores, num_positions: int = 3,
                     k: int = dmod.REDUCED_TOPK):
    """The confidence leg's candidates out of full ``[m, P, V]`` scores:
    top-``k`` log-probabilities (float32, against the logsumexp) and token
    ids of the first ``num_positions`` positions, ``[m, num_positions,
    k]`` each.  Only ``top_k`` past ``REDUCED_TOPK`` reaches it; otherwise
    the decode's ReducedScores already hold the candidates."""
    sub = scores[:, :num_positions, :].float()
    logz = torch.logsumexp(sub, dim=-1)
    vals, idx = torch.topk(sub, k, dim=-1)
    return vals - logz[..., None], idx


@dataclasses.dataclass
class EngineConfig:
    """The reference's engine knobs, same names and defaults, each honoured
    as in the reference: ``decode_completions`` and ``max_new_tokens``,
    ``completion_chars``, ``phase2_pool`` with its target, slice and byte
    cap, ``pooled_confidence``, ``slot_repack``, ``pipeline_depth`` (>= 1)
    and the OOM ladder (``oom_backoff``, ``oom_batch_floor``,
    ``oom_batch_ladder``), ``prefill_chunk`` (> 0: a prompt bucket longer
    than it prefills in chunks, ``models.decoder.chunked_prefill``).
    ``kv_dtype`` ("bf16" or "int8") sets the decoder's ``kv_cache_dtype``
    at construction.  ``decode_k`` > 1 decodes in joint K-token verify
    passes once the engine has a K-head (decoder-only; T5 decodes as with
    1)."""
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
    phase2_pool_target: int = 0     # rows per pooled decode; 0 -> batch_size
    phase2_select_slice: int = 0    # 0 -> batch_size // 4 (at least 8)
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
    """Raise NotImplementedError for every setting the port cannot honour."""
    if ecfg.kv_dtype not in ("bf16", "int8"):
        raise ValueError(f"unknown kv_dtype {ecfg.kv_dtype!r}")
    if mesh is not None:
        raise NotImplementedError(
            f"a device mesh is not ported yet ({_ITEM_PAR})")


@dataclasses.dataclass
class LegSpec:
    """One suffix leg of a fused prefix-reuse call
    (:meth:`ScoringEngine.score_prefixed`).  The full-study row is two legs
    over one prefix: binary (50-token completion) and confidence
    (``with_confidence`` with a 10-token cap).  ``max_new_tokens`` keys the
    leg's own generation plan; ``decode_completions=None`` inherits the
    engine config."""

    name: str = ""
    with_confidence: bool = False
    max_new_tokens: Optional[int] = None
    decode_completions: Optional[bool] = None


class PrefixCachePool:
    """Lifetime audit of the fused path's per-batch prefix KV caches.

    The cache itself travels in the pipeline's in-flight tuple; this pool
    counts its bytes and pairs every acquire with exactly one release (a
    second release raises; an entry still live at :meth:`close` is counted
    as leaked), and records the ``prefix_hit``/``prefix_miss`` counters.  A
    batch whose launch fails after its prefix prefill releases its entry
    before the OOM re-bucket retries, so retried sub-batches take fresh
    entries and nothing is orphaned or freed twice."""

    class Entry:
        __slots__ = ("nbytes", "rows", "released")

        def __init__(self, nbytes: int, rows: int):
            self.nbytes = int(nbytes)
            self.rows = int(rows)
            self.released = False

    def __init__(self):
        self.live: List[PrefixCachePool.Entry] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self.acquired = 0
        self.released = 0
        self.hits = 0
        self.misses = 0
        self.leaked = 0
        self.closed = False

    def acquire(self, nbytes: int, rows: int) -> "PrefixCachePool.Entry":
        entry = self.Entry(nbytes, rows)
        self.live.append(entry)
        self.live_bytes += entry.nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        self.acquired += 1
        self.misses += entry.rows
        record_counter("prefix_miss", entry.rows)
        return entry

    def hit(self, rows: int) -> None:
        """A leg past the first reused a prefilled prefix for ``rows``
        real rows."""
        self.hits += int(rows)
        record_counter("prefix_hit", int(rows))

    def release(self, entry: "PrefixCachePool.Entry") -> None:
        if entry.released:
            raise RuntimeError(
                "prefix cache entry released twice: a retried sub-batch "
                "must take a fresh entry")
        entry.released = True
        self.live.remove(entry)
        self.live_bytes -= entry.nbytes
        self.released += 1

    def close(self) -> None:
        """End-of-call sweep: a still-live entry is a leak (an error
        propagated past the pipeline); it is force-released and counted.
        Idempotent."""
        if self.closed:
            return
        self.closed = True
        for entry in list(self.live):
            entry.released = True
            self.live.remove(entry)
            self.live_bytes -= entry.nbytes
            self.leaked += 1
        if self.leaked:
            record_counter("prefix_pool_leaked", self.leaked)

    @property
    def consistent(self) -> bool:
        """Every acquire met exactly one release, and nothing leaked."""
        return (not self.live and self.leaked == 0
                and self.acquired == self.released)


class _HostCopy:
    """Small device outputs on their way to the host.

    On a CUDA device each tensor is copied with ``non_blocking=True`` into a
    pinned host tensor as soon as it is launched, and one event is recorded
    behind the copies, so :meth:`numpy` waits for these copies only.  A
    ``.cpu()`` issued later would be queued behind every kernel launched in
    between (with pipelining, the next batch's prefill), and the host would
    wait for those too.  On the CPU the tensors are their own host copies."""

    __slots__ = ("host", "event")

    def __init__(self, tensors: Iterable[torch.Tensor]):
        tensors = list(tensors)
        self.event = None
        if tensors and tensors[0].is_cuda:
            self.host = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self.host.append(h)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = tensors

    def ready(self) -> bool:
        """True once the copies have landed (never blocks)."""
        return self.event is None or self.event.query()

    def numpy(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


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
        if (ecfg.kv_dtype != "bf16" and hasattr(cfg, "kv_cache_dtype")
                and cfg.kv_cache_dtype != ecfg.kv_dtype):
            cfg = dataclasses.replace(cfg, kv_cache_dtype=ecfg.kv_dtype)
        self.family = family
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.tokenizer = tokenizer
        self.mesh = mesh
        self.ecfg = ecfg
        # every OOM back-off step this engine took (the telemetry fault log
        # holds the process-wide list)
        self.fault_events: List[Dict] = []
        self._plan_cache: Dict[Tuple, plan_mod.GenerationPlan] = {}
        # per-ring slot-occupancy stats since the last occupancy_report()
        self._occupancy: List[slots_mod.OccupancyStats] = []
        # the audit of the last score_prefixed call's prefix caches
        self.last_prefix_pool: Optional[PrefixCachePool] = None
        # token id -> text of the confidence leg's candidates
        self._tok_text_cache: Dict[int, str] = {}
        # the K-decode proposal head ({"w": [K-1, H, V]}), when decode_k > 1
        self.k_head = None
        self._k_head_missing_noted = False
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
        _check_supported(self.family, self.ecfg, self.mesh)

    def close(self) -> None:
        """Drop the engine's reference to its weights and return cached
        device memory to the driver.  The caller's ``DecoderWeights`` stay
        usable by other engines; their memory is freed once no one holds
        them.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self.last_prefix_pool is not None:
            self.last_prefix_pool.close()
        self.params = None
        self.k_head = None
        self._plan_cache.clear()
        self._tok_text_cache = {}
        self._occupancy = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def __enter__(self) -> "ScoringEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- helpers ---------------------------------------------------------

    @property
    def is_encoder_decoder(self) -> bool:
        return self.family == "t5"

    def target_ids(self, targets: Sequence[str]) -> List[int]:
        return yn.target_token_ids(self.tokenizer, targets,
                                   self.is_encoder_decoder)

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

    def _gen_plan(self, max_new_tokens: Optional[int] = None,
                  decode_completions: Optional[bool] = None
                  ) -> plan_mod.GenerationPlan:
        """The cached generation plan of one leg: the per-call
        ``max_new_tokens`` and the leg's completion flag (the engine's when
        None) are part of the key, so the binary and confidence legs keep
        plans of their own."""
        ecfg = self.ecfg
        dc = (ecfg.decode_completions if decode_completions is None
              else decode_completions)
        key = plan_mod.plan_cache_key(
            ecfg.score_steps, ecfg.max_look_ahead, ecfg.max_new_tokens,
            dc, max_new_tokens)
        plan = self._plan_cache.get(key)
        if plan is None:
            plan = self._plan_cache[key] = plan_mod.generation_plan(
                ecfg.score_steps, ecfg.max_look_ahead, ecfg.max_new_tokens,
                dc, max_new_tokens)
        return plan

    def _completion_text(self, row_tokens, eos_id) -> str:
        """One row's generated tokens as the reference records
        ``completion``: cut at the first EOS, special tokens skipped,
        stripped, truncated to ``completion_chars``."""
        ids = []
        for t in row_tokens:
            t = int(t)
            if eos_id is not None and t == eos_id:
                break
            ids.append(t)
        return self.tokenizer.decode(ids, skip_special_tokens=True).strip()[
            : self.ecfg.completion_chars]

    def _candidates_from_topk(self, lp_row, idx_row):
        """(token text, logprob) candidate lists of one row, one list a
        position, from its top-k log-probabilities and ids ``[P, k]``: the
        input of ``weighted_confidence_digits``.  Token texts are memoized
        by id."""
        cache = self._tok_text_cache
        positions = []
        for p in range(lp_row.shape[0]):
            cands = []
            for lp, i in zip(lp_row[p], idx_row[p]):
                i = int(i)
                text = cache.get(i)
                if text is None:
                    text = cache[i] = self.tokenizer.decode([i])
                cands.append((text, float(lp)))
            positions.append(cands)
        return positions

    @staticmethod
    def _conf_topk_np(sc):
        """``[m, 3, 19]`` (log-probabilities, ids) of the confidence leg, as
        numpy, from ReducedScores or full scores."""
        if isinstance(sc, dmod.ReducedScores):
            return ((sc.topk_vals[:, :3] - sc.logz[:, :3, None]).cpu().numpy(),
                    sc.topk_ids[:, :3].cpu().numpy())
        return tuple(a.cpu().numpy() for a in _confidence_topk(sc))

    def _tensor(self, arr, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), device=self.device, dtype=dtype)

    def _batches(self, encoded):
        ecfg = self.ecfg
        return batching.batches_for_prompts(
            encoded, ecfg.batch_size, ecfg.buckets,
            pad_id=self.tokenizer.pad_token_id or 0,
            length_sorted=ecfg.length_sorted_batches)

    # -- pipelining and the OOM ladder ----------------------------------

    def _run_pipelined(self, batches: Iterable, launch: Callable,
                       consume: Callable, rebatch: Optional[Callable] = None):
        """Launch batches up to ``pipeline_depth`` ahead of consuming them.

        ``launch`` queues a batch's device work and returns at once (CUDA
        launches are asynchronous; its small outputs go to the host through
        a :class:`_HostCopy`); ``consume`` reads them.  While the host
        consumes batch k, the device runs batch k+1.

        ``rebatch(batch, err)`` is the OOM back-off hook
        (:meth:`_oom_rebatch`): when a batch's launch or consume raises a
        device OOM, it returns sub-batches of the same real rows at a
        smaller size, queued ahead of the remaining input; anything it
        cannot absorb it re-raises.  A consume that fails part-way
        re-scores its whole batch; results are keyed by prompt index, so
        the rewrite is idempotent."""
        depth = max(1, int(self.ecfg.pipeline_depth))
        pending: collections.deque = collections.deque()
        retries: collections.deque = collections.deque()
        stepped_down = False
        it = iter(batches)

        def handle(batch, err):
            nonlocal stepped_down
            if rebatch is None:
                raise err
            retries.extend(rebatch(batch, err))  # re-raises what it cannot take
            stepped_down = True

        while True:
            if stepped_down and self.device.type == "cuda":
                # The failed attempt's tensors died with its traceback at
                # the end of the except block.  Release their cached
                # segments, cut to the larger batch's sizes: otherwise the
                # retry's allocations split them, and split segments
                # cannot be released again under a memory cap.
                torch.cuda.empty_cache()
            stepped_down = False
            batch = retries.popleft() if retries else next(it, None)
            if batch is not None:
                try:
                    pending.append((batch, launch(batch)))
                except Exception as err:
                    handle(batch, err)
                    continue
            elif not pending:
                break
            if len(pending) >= depth or batch is None:
                done, out = pending.popleft()
                try:
                    consume(done, out)
                except Exception as err:
                    out = None           # the failed batch's device outputs
                    handle(done, err)
                out = None

    def _oom_rebatch(self, encoded) -> Optional[Callable]:
        """Per-call OOM back-off hook for :meth:`_run_pipelined`: for a
        device OOM, the failed batch's size steps down the ladder (halving
        between ladder points, never below ``oom_batch_floor``) and its real
        rows are re-bucketed (``batching.rebatch``); the step is recorded in
        telemetry and on ``self.fault_events``.  Non-OOM errors, errors
        marked ``_no_rebatch`` and OOMs at the floor re-raise.  None when
        back-off is off."""
        ecfg = self.ecfg
        if not ecfg.oom_backoff:
            return None

        def rebatch(batch, err):
            # _no_rebatch marks errors whose device work spans rows of other
            # batches (the pooled decode): stepping this batch down cannot
            # shrink it, and a retry would lose the pooled rows
            if getattr(err, "_no_rebatch", False) or not faults.is_oom(err):
                raise err
            size = int(batch.token_ids.shape[0])
            new_size = faults.next_batch_down(
                size, ladder=ecfg.oom_batch_ladder, floor=ecfg.oom_batch_floor)
            if new_size is None:
                raise err
            n_real = int((batch.indices >= 0).sum())
            event = record_fault(
                "engine_oom_backoff", batch=size, new_batch=new_size,
                bucket_len=int(batch.bucket_len), rows=n_real,
                error=faults.oom_detail(err))
            self.fault_events.append(event)
            print(f"# engine: device OOM at batch {size} "
                  f"(bucket {batch.bucket_len}); retrying {n_real} rows at "
                  f"batch {new_size} [{faults.oom_detail(err)}]",
                  file=sys.stderr)
            return batching.rebatch(
                batch, encoded, new_size, ecfg.buckets,
                pad_id=self.tokenizer.pad_token_id or 0,
                length_sorted=ecfg.length_sorted_batches)

        return rebatch

    def _prefill(self, ids, mask, cache_len: int):
        """One prompt forward -> (last logits, KVCache): monolithic
        :func:`models.decoder.prefill`, or, when ``prefill_chunk`` is set
        and the bucket exceeds it, the chunked replay through the
        suffix-extension path (:func:`models.decoder.chunked_prefill`),
        which bounds the long buckets' attention transients.

        Counters: ``prefill_chunks`` counts the chunks of each chunked
        prefill (the proof the chunked path ran) and, with an int8 KV cache,
        ``kv_cache_bytes_saved`` adds the bytes the quantized cache does not
        hold against its bf16 layout; both come from shapes, with no host
        sync."""
        chunk = int(self.ecfg.prefill_chunk or 0)
        if chunk > 0 and cache_len > chunk:
            last, cache, n_chunks = dmod.chunked_prefill(
                self.params, self.cfg, ids, mask, chunk)
            record_counter("prefill_chunks", n_chunks)
        else:
            last, cache = dmod.prefill(self.params, self.cfg, ids, mask,
                                       cache_len=cache_len)
        if cache.k_scale is not None:
            bf16_bytes = 2 * (cache.k.numel() + cache.v.numel())
            record_counter("kv_cache_bytes_saved",
                           bf16_bytes - slots_mod._cache_nbytes(cache))
        return last, cache

    # -- core ------------------------------------------------------------

    def score_prompts(
        self,
        prompts: Sequence,
        targets: Sequence = ("Yes", "No"),
        with_confidence: bool = False,
        max_new_tokens: Optional[int] = None,
    ) -> List[Dict]:
        """Yes/No scoring: one dict per prompt with yes_prob, no_prob,
        relative_prob, odds_ratio, scan_found, completion (empty unless
        ``decode_completions``), success, the first_token_{yes,no,relative}
        _prob fields and, ``with_confidence``, weighted_confidence.

        Prompts are strings, pre-tokenized id sequences, or ``(prefix,
        suffix)`` 2-tuples, which go through :meth:`score_prefixed` with
        one leg.  ``targets`` is one (yes, no) pair or one pair per prompt.
        ``max_new_tokens`` overrides the completion cap for this call only
        (never below the scored scan's steps)."""
        self._check_open()
        if prompts and _is_prefix_pair(prompts[0]):
            leg = LegSpec(with_confidence=with_confidence,
                          max_new_tokens=max_new_tokens)
            return self.score_prefixed(
                [(p[0], (p[1],)) for p in prompts], targets=targets,
                legs=[leg])[0]
        if self.is_encoder_decoder:
            return self._score_encdec(prompts, targets, with_confidence,
                                      max_new_tokens)
        ecfg = self.ecfg
        ids_all = self._target_id_rows(prompts, targets)   # [N, 2]
        eos_id = getattr(self.tokenizer, "eos_token_id", None)
        encoded = batching.encode_prompts(self.tokenizer, prompts)
        results: List[Optional[Dict]] = [None] * len(prompts)
        steps, gen_total = self._gen_plan(max_new_tokens)
        if (ecfg.phase2_pool and not with_confidence
                and not ecfg.decode_completions):
            return self._score_decoder_pooled(encoded, ids_all, results,
                                              eos_id, steps)
        if self._conf_pool_eligible(with_confidence, steps, gen_total):
            return self._score_decoder_conf_pooled(encoded, ids_all, results,
                                                   eos_id, steps)

        def launch(batch):
            return self._launch(batch, ids_all)

        def consume(batch, out):
            self._consume_scored_batch(
                batch, out, ids_all, results, with_confidence, steps,
                gen_total, ecfg.decode_completions, eos_id)

        self._run_pipelined(self._batches(encoded), launch, consume,
                            rebatch=self._oom_rebatch(encoded))
        return [r if r is not None else _error_row("missing") for r in results]

    def score_prefixed(
        self,
        pairs: Sequence,
        targets: Sequence = ("Yes", "No"),
        legs: Optional[Sequence[LegSpec]] = None,
    ) -> List[List[Dict]]:
        """Fused multi-leg scoring over shared prefixes: the full-study
        row's path.

        ``pairs``: one ``(prefix, suffixes)`` tuple per row, ``suffixes``
        holding one format suffix per leg (strings tokenize once per
        distinct text, without special tokens; id lists pass through).
        ``legs`` configures each leg (default: plain scoring); ``targets``
        is one (yes, no) pair or one pair per row, shared by every leg.

        Each batch's prefixes prefill once into a bucketed KV cache and
        every leg runs as a short suffix-extension prefill against it
        (``models.decoder.extend_prefill``); each leg then consumes with its
        own generation plan.  Returns one list of result rows per leg,
        aligned with ``pairs``.  The prefix caches' lifetimes are audited on
        ``self.last_prefix_pool``."""
        self._check_open()
        n_legs = len(legs) if legs is not None else (
            len(pairs[0][1]) if pairs else 1)
        legs = list(legs) if legs is not None else [
            LegSpec() for _ in range(n_legs)]
        if pairs and len(pairs[0][1]) != len(legs):
            raise ValueError(
                f"{len(legs)} legs configured but pairs carry "
                f"{len(pairs[0][1])} suffixes")
        if not pairs:
            return [[] for _ in legs]
        prefix_encoded, suffix_encoded = batching.encode_prefix_pairs(
            self.tokenizer, pairs)
        if self.is_encoder_decoder:
            # T5 has no decoder-side prompt cache to extend (the encoder
            # reads the whole prompt every leg): each leg scores the joined
            # token streams, tokenized once
            return [
                self.score_prompts(
                    [list(p) + list(s) for p, s in
                     zip(prefix_encoded, suffix_encoded[li])],
                    targets=targets, with_confidence=leg.with_confidence,
                    max_new_tokens=leg.max_new_tokens)
                for li, leg in enumerate(legs)
            ]
        return self._score_decoder_prefixed(prefix_encoded, suffix_encoded,
                                            targets, legs)

    def _score_encdec(self, prompts, targets, with_confidence,
                      max_new_tokens=None) -> List[Dict]:
        """T5: one greedy decode a batch (``models.t5.greedy_decode``, the
        decoder re-running its short prefix each step) of ``max_new_tokens``
        steps when completions are recorded, scored over the first
        ``max_look_ahead`` steps only; the scan stops at a row's EOS."""
        ecfg = self.ecfg
        ids_all = self._target_id_rows(prompts, targets)
        eos_id = getattr(self.tokenizer, "eos_token_id", None)
        encoded = batching.encode_prompts(self.tokenizer, prompts)
        results: List[Optional[Dict]] = [None] * len(prompts)
        steps, gen_total = self._gen_plan(max_new_tokens)

        def launch(batch):
            ids = self._tensor(batch.token_ids, torch.int64)
            mask = self._tensor(batch.attention_mask, torch.int32)
            tokens, scores = t5mod.greedy_decode(
                self.params, self.cfg, ids, mask, num_steps=gen_total,
                eos_token_id=eos_id, score_steps=steps)
            row_ids = self._tensor(self._batch_target_rows(ids_all, batch),
                                   torch.int64)
            res = yn.yes_no_from_scores(
                scores, row_ids[:, 0], row_ids[:, 1],
                max_look_ahead=ecfg.max_look_ahead, top_k=ecfg.top_k,
                valid_steps=yn.steps_until_eos(tokens[:, :steps], eos_id))
            first3 = yn.relative_prob_first_token(
                scores[:, 0, :], row_ids[:, 0], row_ids[:, 1],
                ecfg.first_token_top_filter)
            # the confidence leg needs only 3 x 19 candidates a row
            conf = _confidence_topk(scores) if with_confidence else ()
            return _HostCopy((tokens, *(getattr(res, f) for f in _SCAN_FIELDS),
                              *first3, *conf))

        def consume(batch, out):
            tokens, *rest = out.numpy()
            scan, first3 = rest[:5], rest[5:8]
            conf_lp, conf_idx = rest[8:] if with_confidence else (None, None)
            for r, orig in enumerate(batch.indices):
                if orig < 0:
                    continue
                completion = ""
                if ecfg.decode_completions:
                    completion = self._completion_text(tokens[r], eos_id)
                row = _attach_first_token(
                    _result_row(*(a[r] for a in scan), completion), first3, r)
                if with_confidence:
                    row["weighted_confidence"] = \
                        conf_mod.weighted_confidence_digits(
                            self._candidates_from_topk(conf_lp[r],
                                                       conf_idx[r]))
                results[int(orig)] = row

        self._run_pipelined(self._batches(encoded), launch, consume,
                            rebatch=self._oom_rebatch(encoded))
        return [r if r is not None else _error_row("missing") for r in results]

    def _score_decoder_prefixed(self, prefix_encoded, suffix_encoded,
                                targets, legs) -> List[List[Dict]]:
        """Batches form over the prefixes' token lengths; per batch, one
        prefix prefill and one suffix-extension prefill per leg, then each
        leg consumes through the per-batch consumer (or, for an eligible
        confidence leg, its cross-batch pool) with its own plan."""
        ecfg = self.ecfg
        n = len(prefix_encoded)
        ids_all = self._target_id_rows(prefix_encoded, targets)
        eos_id = getattr(self.tokenizer, "eos_token_id", None)
        results: List[List[Optional[Dict]]] = [[None] * n for _ in legs]
        decode_flags = [
            ecfg.decode_completions if leg.decode_completions is None
            else leg.decode_completions for leg in legs]
        plans = [self._gen_plan(leg.max_new_tokens, decode_flags[li])
                 for li, leg in enumerate(legs)]
        pad_id = self.tokenizer.pad_token_id or 0
        pool = PrefixCachePool()
        self.last_prefix_pool = pool
        conf_pools = {
            li: self._make_conf_pool(
                plans[li].scan_steps, eos_id, results[li],
                leg_name=leg.name or "confidence",
                completions=decode_flags[li])
            for li, leg in enumerate(legs)
            if self._conf_pool_eligible(
                leg.with_confidence, plans[li].scan_steps,
                plans[li].total_new_tokens)
        }

        def suffix_batch(batch, li):
            """[B, suffix bucket] ids and mask of one leg, aligned with the
            batch's rows; pad rows (index -1) take row 0's suffix, as the
            batcher's pad rows take row 0's prefix."""
            rows = [suffix_encoded[li][int(orig)] if orig >= 0 else None
                    for orig in batch.indices]
            first = next(r for r in rows if r is not None)
            rows = [r if r is not None else first for r in rows]
            sb = batching.suffix_bucket_for(max(len(r) for r in rows))
            ids = np.full((len(rows), sb), pad_id, np.int64)
            mask = np.zeros((len(rows), sb), np.int32)
            for r, src in enumerate(rows):
                ids[r, : len(src)] = src
                mask[r, : len(src)] = 1
            return ids, mask

        def launch(batch):
            entry = None
            try:
                mask = self._tensor(batch.attention_mask, torch.int32)
                _, pcache = self._prefill(
                    self._tensor(batch.token_ids, torch.int64), mask,
                    batch.bucket_len)
                plen = mask.sum(-1)
                n_real = int((batch.indices >= 0).sum())
                entry = pool.acquire(slots_mod._cache_nbytes(pcache), n_real)
                row_ids = self._tensor(self._batch_target_rows(ids_all, batch),
                                       torch.int64)
                leg_outs = []
                for li in range(len(legs)):
                    sids, smask = suffix_batch(batch, li)
                    last, cache, lengths = dmod.extend_prefill(
                        self.params, self.cfg, pcache, self._tensor(sids),
                        self._tensor(smask), plen)
                    scan0 = yn.first_token_scan(
                        last, row_ids[:, 0], row_ids[:, 1], top_k=ecfg.top_k)
                    first3 = yn.relative_prob_first_token(
                        last, row_ids[:, 0], row_ids[:, 1],
                        ecfg.first_token_top_filter)
                    leg_outs.append((last, cache, lengths,
                                     _HostCopy((*scan0, *first3))))
                    if li:              # every later leg rides the cache
                        pool.hit(n_real)
                return entry, leg_outs
            except Exception:
                # the OOM re-bucket retries this batch's rows in fresh
                # sub-batches with entries of their own: this one ends now
                if entry is not None:
                    pool.release(entry)
                raise

        def consume(batch, out):
            entry, leg_outs = out
            try:
                for li in range(len(legs)):
                    if li in conf_pools:
                        self._pool_confidence_batch(
                            conf_pools[li], batch, leg_outs[li], ids_all)
                    else:
                        self._consume_scored_batch(
                            batch, leg_outs[li], ids_all, results[li],
                            legs[li].with_confidence, plans[li].scan_steps,
                            plans[li].total_new_tokens, decode_flags[li],
                            eos_id)
            finally:
                # exactly once, whether the legs consumed or an OOM sends
                # the batch back through the re-bucket ladder
                pool.release(entry)

        try:
            self._run_pipelined(self._batches(prefix_encoded), launch,
                                consume,
                                rebatch=self._oom_rebatch(prefix_encoded))
        finally:
            pool.close()
        for cpool in conf_pools.values():
            cpool.flush_all()
        return [[r if r is not None else _error_row("missing") for r in rows]
                for rows in results]

    def _launch(self, batch, ids_all):
        """Prefill one batch and run the position-0 scans on the device."""
        ecfg = self.ecfg
        ids = self._tensor(batch.token_ids, torch.int64)
        mask = self._tensor(batch.attention_mask, torch.int32)
        # cache_len == bucket length: decode folds its tails in per chunk
        last, cache = self._prefill(ids, mask, batch.bucket_len)
        lengths = mask.sum(-1)
        row_ids = self._tensor(self._batch_target_rows(ids_all, batch),
                               torch.int64)
        scan0 = yn.first_token_scan(last, row_ids[:, 0], row_ids[:, 1],
                                    top_k=ecfg.top_k)
        first3 = yn.relative_prob_first_token(
            last, row_ids[:, 0], row_ids[:, 1], ecfg.first_token_top_filter)
        return last, cache, lengths, _HostCopy((*scan0, *first3))

    def _consume_scored_batch(self, batch, out, ids_all, results,
                              with_confidence, steps, gen_total,
                              decode_completions, eos_id):
        """One launched batch into ``results`` (keyed by prompt index, so a
        re-consume after an OOM re-bucket is idempotent): the position-0
        reads, the completion chunks, the scored look-ahead of the rows
        that need it (every row with confidence) and the confidence
        candidates.  ``out`` is (last logits, cache, lengths, host copy of
        scan0 and first3), from a prompt prefill or a leg's
        suffix-extension prefill; ``steps``, ``gen_total`` and
        ``decode_completions`` are the leg's plan."""
        ecfg = self.ecfg
        last, cache, lengths, fetched = out
        host = fetched.numpy()
        scan0, first3 = host[:5], host[5:]
        hit0 = scan0[4]
        row_ids = self._batch_target_rows(ids_all, batch)
        valid = batch.indices >= 0
        undecided = np.flatnonzero(valid if with_confidence
                                   else ~hit0 & valid)
        need_scores = undecided.size > 0
        tokens_np = None      # [B, generated] when completions decode
        conf_lp = conf_idx = None
        res_np = None         # the scan over positions 0..steps-1
        sub_pos = None        # batch row -> row in the subset arrays

        if decode_completions:
            # every row generates its completion; the first chunk doubles
            # as the scored look-ahead when any row needs scores
            reduced = ecfg.top_k <= dmod.REDUCED_TOPK
            tids = self._tensor(row_ids, torch.int64)
            use_k = self._k_active()
            prev_h = None         # the K path's frontier hidden
            prev, done, offset = last, None, 0
            chunk_toks, scores_dev = [], None
            lag = None            # host copy of the previous chunk's all-done
            while offset < gen_total:
                n = min(steps, gen_total - offset)
                ws = offset == 0 and need_scores
                mode = ("reduced" if reduced else True) if ws else False
                tgt = tids if ws and reduced else None
                if use_k:
                    # the chunk in joint K-token verify passes; the chunk
                    # boundaries (and fold points) are the sequential ones
                    toks, sc, cache, prev, done, prev_h = \
                        self._k_decode_chunk(
                            cache, prev, lengths, offset, n, eos_id, done,
                            mode, tgt, prev_h, valid, "completion")
                else:
                    toks, sc, cache, prev, done = dmod.decode_steps(
                        self.params, self.cfg, cache, prev, lengths, offset,
                        n, eos_id, done, with_scores=mode, target_ids=tgt)
                if ws:
                    scores_dev = sc
                chunk_toks.append(toks)
                offset += n
                if use_k and eos_id is not None and offset < gen_total:
                    # the K path read this chunk's acceptance already, so
                    # the EOS stop is exact (no lag chunk)
                    if bool(done.all()):
                        break
                    continue
                if eos_id is not None and offset < gen_total:
                    # EOS stop one chunk late: the flag of chunk k is read
                    # after chunk k+1 is queued, so the device never waits
                    # for the host; the surplus chunk's tokens are EOS
                    if lag is not None and bool(lag.numpy()[0]):
                        break
                    lag = _HostCopy([done.all()])
            if eos_id is not None and offset < gen_total:
                record_counter("decode_steps_saved",
                               (gen_total - offset) * int(valid.sum()))
            tokens_np = torch.cat(chunk_toks, dim=1).cpu().numpy()
            if need_scores:
                sc_steps = (dmod.ReducedScores(*(f[:, :steps]
                                                 for f in scores_dev))
                            if reduced else scores_dev[:, :steps])
                res = self._scan_results(sc_steps, row_ids[:, 0],
                                         row_ids[:, 1],
                                         chunk_toks[0][:, :steps], eos_id)
                res_np = {k: v.cpu().numpy()
                          for k, v in res._asdict().items()}
                if with_confidence:
                    conf_lp, conf_idx = self._conf_topk_np(scores_dev)
        elif need_scores:
            # scored decode of the rows that need it, gathered out of the
            # prefill cache unless most of the batch does
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
                ids_sub[:, 0], ids_sub[:, 1],
                min_steps=3 if with_confidence else 0, real_mask=real)
            res = self._scan_results(sc, ids_sub[:, 0], ids_sub[:, 1],
                                     toks_s, eos_id)
            res_np = {k: v.cpu().numpy() for k, v in res._asdict().items()}
            if with_confidence:
                conf_lp, conf_idx = self._conf_topk_np(sc)

        for r, orig in enumerate(batch.indices):
            if orig < 0:
                continue
            if hit0[r] and not with_confidence:
                vals = tuple(a[r] for a in scan0[:4]) + (True,)
            else:
                j = r if sub_pos is None else sub_pos[r]
                vals = tuple(res_np[k][j] for k in _SCAN_FIELDS)
            completion = ""
            if decode_completions:
                completion = self._completion_text(tokens_np[r], eos_id)
            row = _attach_first_token(_result_row(*vals, completion),
                                      first3, r)
            if with_confidence:
                k = r if sub_pos is None else sub_pos[r]
                row["weighted_confidence"] = \
                    conf_mod.weighted_confidence_digits(
                        self._candidates_from_topk(conf_lp[k], conf_idx[k]))
            results[int(orig)] = row

    def _launch_select(self, batch, ids_all, slice_m: int,
                       out_len: Optional[int] = None,
                       select_all: bool = False):
        """:func:`_prefill_select` on one batch: the device part of the
        pooled and slotted routes (``out_len`` defaults to the binary pool's
        length of the bucket).  Returns (host copy of scan0, first3 and sel;
        the slice's cache, last logits, lengths)."""
        ecfg = self.ecfg
        row_ids = self._tensor(self._batch_target_rows(ids_all, batch),
                               torch.int64)
        scan0, first3, sel, sub, last_s, len_s = _prefill_select(
            self.params, self.cfg, self._tensor(batch.token_ids, torch.int64),
            self._tensor(batch.attention_mask, torch.int32),
            self._tensor(batch.indices >= 0), row_ids[:, 0], row_ids[:, 1],
            cache_len=batch.bucket_len, slice_m=slice_m, top_k=ecfg.top_k,
            top_filter=ecfg.first_token_top_filter,
            out_len=(_pool_len(batch.bucket_len) if out_len is None
                     else out_len),
            select_all=select_all)
        return _HostCopy((*scan0, *first3, sel)), sub, last_s, len_s

    def _score_decoder_pooled(self, encoded, ids_all, results, eos_id,
                              steps) -> List[Dict]:
        """The pooled route: each batch's prefill keeps only a
        ``phase2_select_slice``-row cache slice, undecided rows first, and
        the undecided rows of many batches decode together in
        :class:`_Phase2Pool`.  A batch with more undecided rows than the
        slice holds re-runs its prefill with the full cache and decodes in
        place (it was going to decode near-full anyway)."""
        ecfg = self.ecfg
        pool = _Phase2Pool(
            self, steps, eos_id,
            target=ecfg.phase2_pool_target or ecfg.batch_size,
            results=results, max_bytes=ecfg.phase2_pool_max_bytes,
        )
        select_m = _pad_slice(
            ecfg.phase2_select_slice or max(8, ecfg.batch_size // 4),
            ecfg.batch_size)

        def launch(batch):
            return self._launch_select(batch, ids_all, select_m)

        def consume(batch, out):
            fetched, sub_cache, last_s, len_s = out
            host = fetched.numpy()
            scan0, first3, sel_np = host[:5], host[5:8], host[8]
            row_ids = self._batch_target_rows(ids_all, batch)
            valid = batch.indices >= 0
            count = int(np.count_nonzero(~scan0[4] & valid))
            # the slice actually produced: select_m normally, but an OOM-
            # rebatched sub-batch smaller than select_m yields its own size
            slice_rows = int(sel_np.shape[0])
            if count > slice_rows:
                self._score_overflow_batch(batch, row_ids, valid, steps,
                                           eos_id, scan0, first3, results)
                return
            if count:
                # slice rows 0..count-1 are the undecided rows (the sort key
                # is False for exactly those rows); every per-row
                # association goes through sel.  Shrink to the tight menu
                # size before pooling, so held bytes follow the real rows.
                m = _pad_slice(count, slice_rows)
                if m < slice_rows:
                    idx = np.zeros((m,), np.int64)
                    idx[:count] = np.arange(count)
                    sub_cache, last_s, len_s = _gather_rows(
                        sub_cache, last_s, len_s, self._tensor(idx))
                    mapped = sel_np[idx]
                else:
                    mapped = sel_np[:slice_rows]
                try:
                    pool.add(_pool_len(batch.bucket_len), sub_cache, last_s,
                             len_s, count, batch.indices[mapped[:count]],
                             row_ids[mapped],
                             first3=np.stack([a[mapped] for a in first3],
                                             axis=1))
                except Exception as err:
                    # a pooled decode holds rows of many earlier batches:
                    # re-bucketing the batch that triggered it cannot
                    # shrink it, and the pooled rows would come back as
                    # "missing" after the retry -- propagate instead
                    err._no_rebatch = True
                    raise
            _write_batch_rows(batch, scan0, first3, results)

        self._run_pipelined(self._batches(encoded), launch, consume,
                            rebatch=self._oom_rebatch(encoded))
        pool.flush_all()
        return [r if r is not None else _error_row("missing") for r in results]

    def _score_overflow_batch(self, batch, row_ids, valid, steps, eos_id,
                              scan0, first3, results):
        """The pooled route's fallback for a batch whose undecided rows
        overflow the selection slice: prefill again with the full cache and
        decode the whole batch in place."""
        ids = self._tensor(batch.token_ids, torch.int64)
        mask = self._tensor(batch.attention_mask, torch.int32)
        last, cache = self._prefill(ids, mask, batch.bucket_len)
        sc, toks = self._scan_decode_chunked(
            cache, last, mask.sum(-1), steps, eos_id,
            row_ids[:, 0], row_ids[:, 1], real_mask=valid)
        res = self._scan_results(sc, row_ids[:, 0], row_ids[:, 1], toks,
                                 eos_id)
        res_np = {k: v.cpu().numpy() for k, v in res._asdict().items()}
        _write_batch_rows(batch, scan0, first3, results, res_np)

    # -- the pooled confidence leg ----------------------------------------

    def _conf_pool_eligible(self, with_confidence, steps, gen_total) -> bool:
        """A confidence leg goes through the cross-batch pool when pooling
        is on for it, its completion cap fits inside the scored scan (the
        scored decode's greedy tokens are then the completion) and the
        scan's top-k reads from ReducedScores' kept candidates."""
        ecfg = self.ecfg
        return bool(with_confidence and ecfg.phase2_pool
                    and ecfg.pooled_confidence and gen_total <= steps
                    and ecfg.top_k <= dmod.REDUCED_TOPK)

    def _make_conf_pool(self, steps, eos_id, results, leg_name="confidence",
                        completions=None):
        ecfg = self.ecfg
        return _Phase2Pool(
            self, steps, eos_id,
            target=ecfg.phase2_pool_target or ecfg.batch_size,
            results=results, max_bytes=ecfg.phase2_pool_max_bytes,
            leg=leg_name, confidence=True,
            completions=(ecfg.decode_completions if completions is None
                         else completions))

    @staticmethod
    def _pool_add_batch(pool, plen, sub_cache, last_s, len_s, count,
                        orig_idx, row_ids, first3_cols, sel):
        """Queue one batch's confidence rows on ``pool``, mapped through
        ``sel`` (slice row -> batch row).  A failure is marked
        ``_no_rebatch``: the pooled decode holds rows of many earlier
        batches, which re-bucketing this one cannot shrink and a retry
        would lose."""
        try:
            pool.add(plen, sub_cache, last_s, len_s, count,
                     orig_idx[sel[:count]], row_ids[sel],
                     first3=np.stack([a[sel] for a in first3_cols], axis=1))
        except Exception as err:
            err._no_rebatch = True
            raise

    def _score_decoder_conf_pooled(self, encoded, ids_all, results, eos_id,
                                   steps) -> List[Dict]:
        """The confidence leg through the cross-batch pool: every valid
        row needs the scored decode, so each prefill keeps all of them
        (``_prefill_select`` with ``select_all``, padded to the confidence
        pool's length) and they decode in a ``confidence=True`` pool."""
        pool = self._make_conf_pool(steps, eos_id, results)

        def launch(batch):
            return self._launch_select(
                batch, ids_all, int(batch.token_ids.shape[0]),
                out_len=_conf_pool_len(batch.bucket_len), select_all=True)

        def consume(batch, out):
            fetched, sub_cache, last_s, len_s = out
            host = fetched.numpy()
            first3, sel_np = host[5:8], host[8]
            row_ids = self._batch_target_rows(ids_all, batch)
            count = int((batch.indices >= 0).sum())
            if not count:
                return
            # valid rows sort first; a partial batch shrinks to its menu size
            m = _pad_slice(count, int(sel_np.shape[0]))
            if m < sel_np.shape[0]:
                idx = np.zeros((m,), np.int64)
                idx[:count] = np.arange(count)
                sub_cache, last_s, len_s = _gather_rows(
                    sub_cache, last_s, len_s, self._tensor(idx))
                mapped = sel_np[idx]
            else:
                mapped = sel_np
            self._pool_add_batch(
                pool, _conf_pool_len(batch.bucket_len), sub_cache, last_s,
                len_s, count, batch.indices, row_ids, first3, mapped)

        self._run_pipelined(self._batches(encoded), launch, consume,
                            rebatch=self._oom_rebatch(encoded))
        pool.flush_all()
        return [r if r is not None else _error_row("missing") for r in results]

    def _pool_confidence_batch(self, pool, batch, out, ids_all):
        """A fused call's confidence leg into its pool: the batch's valid
        rows gathered out of the suffix-extended cache, the slot axis padded
        to the pool's quantized length."""
        last, cache, lengths, fetched = out
        first3 = fetched.numpy()[5:]
        row_ids = self._batch_target_rows(ids_all, batch)
        valid = batch.indices >= 0
        count = int(valid.sum())
        if not count:
            return
        m = _pad_slice(count, int(last.shape[0]))
        idx = np.zeros((m,), np.int64)
        idx[:count] = np.flatnonzero(valid)
        sub_cache, last_s, len_s = _gather_rows(cache, last, lengths,
                                                self._tensor(idx))
        cache_len = int(sub_cache.k.shape[2])
        plen = _conf_pool_len(cache_len)
        if plen > cache_len:
            sub_cache = slots_mod._pad_cache_to(sub_cache, plen)
        self._pool_add_batch(pool, plen, sub_cache, last_s, len_s, count,
                             batch.indices, row_ids, first3, idx)

    def _scan_results(self, sc, yes_ids, no_ids, toks, eos_id):
        """Yes/no scan over a decode's scores (full [m, P, V] scores or
        ReducedScores, whichever the decode produced)."""
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
                             yes_id, no_id, min_steps: int = 0,
                             real_mask: Optional[np.ndarray] = None):
        """Scored look-ahead decode in ``scan_chunk``-step chunks with early
        exit once every real row has a top-k hit or has emitted EOS (no later
        position can change its scan), never before ``min_steps`` (the
        confidence leg reads 3 positions).  Returns (scores, tokens [m, P]),
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
            sub_cache, last_s, len_s, steps, eos_id, min_steps, real_mask,
            chunk, reduced, target_ids, yes_id, no_id)

    def _scan_decode_loop(self, sub_cache, last_s, len_s, steps, eos_id,
                          min_steps, real_mask, chunk, reduced, target_ids,
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
            if offset >= min_steps and bool(resolved.all()):
                break
        return _cat_scores(sc_parts, reduced), torch.cat(tok_parts, dim=1)

    # -- joint next-K-token decode (verify and accept) -------------------

    def _k_enabled(self) -> bool:
        """``decode_k`` asks for the K path (decoder-only: T5 re-reads its
        prompt every step, with no frontier cache to verify against)."""
        return int(self.ecfg.decode_k) > 1 and not self.is_encoder_decoder

    def _k_active(self) -> bool:
        """The K path engages: ``decode_k > 1`` and a K-head is set.  A
        missing head is noted once (``k_decode_head_missing`` and a line on
        stderr) and the decode legs run sequentially."""
        if not self._k_enabled():
            return False
        if self.k_head is None:
            if not self._k_head_missing_noted:
                self._k_head_missing_noted = True
                record_counter("k_decode_head_missing")
                print(f"# engine: decode_k={self.ecfg.decode_k} configured "
                      f"but no K-head is set (distill_k_head_on); decode "
                      f"legs run sequentially", file=sys.stderr)
            return False
        return True

    def distill_k_head_on(self, prompts, max_rows: int = 32,
                          gen_steps: Optional[int] = None):
        """Distill this engine's K-head on up to ``max_rows`` sample prompts
        (``models.decoder.distill_k_head``: ridge probes on the model's own
        greedy continuations) and set it.  None when ``decode_k <= 1``."""
        self._check_open()
        if not self._k_enabled():
            return None
        encoded = batching.encode_prompts(self.tokenizer,
                                          list(prompts)[:max_rows])
        width = max(len(e) for e in encoded)
        ids = np.full((len(encoded), width),
                      self.tokenizer.pad_token_id or 0, np.int64)
        mask = np.zeros((len(encoded), width), np.int32)
        for r, e in enumerate(encoded):
            ids[r, : len(e)] = e
            mask[r, : len(e)] = 1
        self.k_head = dmod.distill_k_head(
            self.params, self.cfg, self._tensor(ids), self._tensor(mask),
            k=int(self.ecfg.decode_k),
            eos_token_id=getattr(self.tokenizer, "eos_token_id", None),
            gen_steps=gen_steps)
        record_counter("k_head_distilled")
        return self.k_head

    def _k_propose(self, hidden, prev_logits, kb, done, eos_id):
        """The proposals of one verify pass (a method, so a caller can put
        another proposal source in its place: the pass re-derives the true
        chain either way).  With no frontier hidden yet (a chunk's bootstrap
        block), only the free, exact argmax."""
        if hidden is None or kb <= 1:
            props = torch.argmax(prev_logits, dim=-1)[:, None]
            if eos_id is not None and done is not None:
                props = torch.where(done[:, None], eos_id, props)
            return props
        return dmod.k_propose(self.k_head, hidden, prev_logits, kb, done,
                              eos_id)

    def _k_decode_chunk(self, cache, prev, lens, offset, n, eos_id, done,
                        with_scores, target_ids, prev_h, real_mask, leg):
        """One chunk of ``n`` positions (one ``decode_steps`` call's worth)
        in joint K-token verify passes.

        The chunk's tail is allocated here and shared by its blocks; it folds
        into the cache only at the chunk's last block, so the fold points
        (an int8 cache's quantization points) are the sequential path's, and
        the chunk-entry ``cache``, ``prev`` and ``done`` are never written.
        Per block: up to ``decode_k`` proposals (``_k_propose``; size 1
        while no frontier hidden exists), one ``k_verify_block`` pass, and
        its acceptance read to the host (one sync a block).  The pass is
        kept only when every real row (``real_mask``: gather padding and
        pool blanks do not veto) matched the whole block; otherwise the
        whole chunk re-runs through ``decode_steps`` from its entry state.

        Counters count speculative passes only (kb > 1; a kb=1 pass cannot
        reject): ``k_blocks_proposed``, ``k_blocks_rejected``, the
        ``accepted_k`` histogram (the least accepted length over the real
        rows) and ``k_steps_saved`` (and ``k_steps_saved|leg=<leg>``),
        recorded only when the whole chunk stayed on the K path.

        Returns ``(toks, scores, cache, prev_logits, done, prev_hidden)``:
        ``decode_steps``' outputs and the frontier hidden for the next chunk
        (None after a fallback)."""
        b = int(prev.shape[0])
        n_real = int(real_mask.sum()) if real_mask is not None else b
        cdt = (dmod._tree(self.params)["embed"]["tokens"].dtype
               if cache.k_scale is not None else cache.k.dtype)
        tail_shape = (self.cfg.num_layers, b, n, self.cfg.num_kv_heads,
                      self.cfg.head_dim)
        tail_k = torch.zeros(tail_shape, dtype=cdt, device=prev.device)
        tail_v = torch.zeros(tail_shape, dtype=cdt, device=prev.device)
        cache0, prev0, done0 = cache, prev, done
        kmax = max(1, min(int(self.ecfg.decode_k),
                          1 + dmod.k_head_num_heads(self.k_head)))
        toks_parts, sc_parts = [], []
        j, cur_done, hid, out = 0, done, prev_h, None
        saved_steps = 0
        while j < n:
            kb = 1 if hid is None else max(1, min(kmax, n - j))
            props = self._k_propose(hid, prev, kb, cur_done, eos_id)
            out = dmod.k_verify_block(
                self.params, self.cfg, cache, tail_k, tail_v, prev, lens,
                offset, j, props, eos_id, cur_done, target_ids,
                with_scores=with_scores, fold=(j + kb >= n))
            a_len, acc = torch.stack(
                [out.a_len, out.accepted.to(out.a_len.dtype)]).cpu().numpy()
            if real_mask is not None:
                a_len, acc = a_len[real_mask], acc[real_mask]
            a_min = int(a_len.min()) if n_real else kb
            ok = bool(acc.all())
            if kb > 1:
                record_counter("k_blocks_proposed")
                record_hist("accepted_k", a_min)
            if not ok:
                record_counter("k_blocks_rejected")
                toks, sc, cache, prev, cur_done = dmod.decode_steps(
                    self.params, self.cfg, cache0, prev0, lens, offset, n,
                    eos_id, done0, with_scores=with_scores,
                    target_ids=target_ids)
                return toks, sc, cache, prev, cur_done, None
            saved_steps += (kb - 1) * n_real
            toks_parts.append(out.tokens)
            if out.scores is not None:
                sc_parts.append(out.scores)
            prev, cur_done, hid = out.last_logits, out.done, out.last_hidden
            j += kb
        if saved_steps:
            record_counter("k_steps_saved", saved_steps)
            record_counter(f"k_steps_saved|leg={leg}", saved_steps)
        toks = torch.cat(toks_parts, dim=1)
        sc = (_cat_scores(sc_parts, with_scores == "reduced") if sc_parts
              else None)
        return toks, sc, out.cache, prev, cur_done, hid

    # -- decode-then-repack consumers (runtime/slots.py) ------------------

    def record_occupancy(self, stats) -> None:
        """Collect one ring's :class:`~.slots.OccupancyStats` (pools and
        slotted sessions call this as they finish)."""
        if stats is not None and (stats.capacity_steps or stats.rows):
            self._occupancy.append(stats)

    def occupancy_report(self, clear: bool = True):
        """Merged slot-occupancy block for everything scored since the last
        drain (None when no ring ran)."""
        merged = slots_mod.merge_occupancy(self._occupancy)
        if clear:
            self._occupancy = []
        return slots_mod.occupancy_block(merged)

    def _binary_ring(self, steps, eos_id, results) -> slots_mod.SlotRing:
        """A binary scored ring of the serve-side entries."""
        ecfg = self.ecfg
        return slots_mod.SlotRing(
            self, steps=steps, eos_id=eos_id,
            capacity=ecfg.phase2_pool_target or ecfg.batch_size,
            leg="binary", workload="serve",
            retire=_binary_retire,
            emit=lambda rows: self._emit_scored_slot_rows(rows, steps,
                                                          eos_id, results),
            batch_review=self._binary_batch_review(steps, eos_id),
            pad_slice=lambda n: _pad_slice(n, max(n, 1)),
        )

    def _select_undecided(self, batch, ids_all, results, base: int):
        """Prefill one batch with an all-rows selection slice, write its
        position-0-decided rows into ``results[base + prompt index]``, and
        return the undecided rows as ring feed parts (cache, last, lengths,
        target ids, metas with prompt index ``orig`` and ``first3``), or
        None when every row is decided."""
        fetched, sub_cache, last_s, len_s = self._launch_select(
            batch, ids_all, int(batch.token_ids.shape[0]))
        host = fetched.numpy()
        scan0, first3, sel_np = host[:5], host[5:8], host[8]
        row_ids = self._batch_target_rows(ids_all, batch)
        _write_batch_rows(batch, scan0, first3, results, base=base)
        count = int(np.count_nonzero(~scan0[4] & (batch.indices >= 0)))
        if not count:
            return None
        idx = self._tensor(np.arange(count), torch.int64)
        mapped = sel_np[:count]
        metas = [{"orig": int(batch.indices[m]),
                  "first3": np.asarray([first3[0][m], first3[1][m],
                                        first3[2][m]])}
                 for m in mapped]
        return (slots_mod._gather_ring_rows(sub_cache, idx), last_s[idx],
                len_s[idx], row_ids[mapped], metas)

    def score_prompts_slotted(
        self,
        prompts: Sequence,
        targets: Sequence = ("Yes", "No"),
        admit_fn: Optional[Callable] = None,
    ) -> List[Dict]:
        """Binary scored decoding through the slot ring with mid-decode
        admission.

        Prompts prefill in ordinary batches; rows whose position-0 scan
        already hit resolve at once, undecided rows feed the ring.  Between
        decode chunks the ring's starvation hook calls ``admit_fn()``, which
        may return ``(prompts, target_pairs)`` of newly arrived work: those
        rows prefill and drop into vacated lanes while earlier rows keep
        decoding.  Results return in feed order (initial prompts first,
        admitted rows appended).  Rows match ``score_prompts`` on the pooled
        route: verdicts identical, probabilities in the chunked-prefill fp32
        class (PARITY.md "Decode-then-repack")."""
        self._check_open()
        if self.is_encoder_decoder:
            raise ValueError("slotted scoring is decoder-only (T5 has no "
                             "decoder-side prompt cache to refill)")
        eos_id = getattr(self.tokenizer, "eos_token_id", None)
        steps, _ = self._gen_plan()
        results: List[Optional[Dict]] = []
        ring = self._binary_ring(steps, eos_id, results)

        def feed(batch_prompts, batch_targets):
            base = len(results)
            results.extend([None] * len(batch_prompts))
            ids_all = self._target_id_rows(batch_prompts, batch_targets)
            encoded = batching.encode_prompts(self.tokenizer, batch_prompts)
            for batch in self._batches(encoded):
                parts = self._select_undecided(batch, ids_all, results, base)
                if parts is not None:
                    cache, last, lens, row_ids, metas = parts
                    for m in metas:
                        m["orig"] += base
                    ring.feed(cache, last, lens, row_ids, metas)

        def refill_hook(n_free):
            # admit_fn owns the admission bound: a hook that never returns
            # empty keeps this session alive
            if admit_fn is None:
                return False
            more = admit_fn()
            if not more:
                return False
            more_prompts, more_targets = more
            if not more_prompts:
                return False
            feed(more_prompts, more_targets)
            slots_mod.slot_counter("slot_admitted", len(more_prompts),
                                   "binary", "serve")
            return True

        ring.refill_hook = refill_hook
        feed(list(prompts), targets)
        ring.drain()
        # one more admission window after the drain, so work that arrived
        # during the last chunk is not orphaned
        while admit_fn is not None and refill_hook(0):
            ring.drain()
        self.record_occupancy(ring.stats)
        return [r if r is not None else _error_row("missing")
                for r in results]

    def _scan_slot_rows(self, rows, vsteps):
        """The yes/no scan over slot rows' accumulated ReducedScores
        statistics, on the host."""
        ecfg = self.ecfg
        return yn.yes_no_from_reduced(
            torch.from_numpy(np.stack([r.vals for r in rows])),
            torch.from_numpy(np.stack([r.logz for r in rows])),
            torch.from_numpy(np.stack([r.tgt for r in rows])),
            max_look_ahead=ecfg.max_look_ahead, top_k=ecfg.top_k,
            valid_steps=torch.from_numpy(vsteps))

    @staticmethod
    def _cut_at_eos(rows, vsteps, eos_id):
        """Scan-visible steps per row: up to and including the first EOS."""
        if eos_id is not None:
            for i, r in enumerate(rows):
                hits = np.flatnonzero(r.toks[: r.decoded] == eos_id)
                if hits.size:
                    vsteps[i] = min(vsteps[i], int(hits[0]) + 1)
        return vsteps

    def _binary_batch_review(self, steps, eos_id):
        """Vectorized found-scan hook for binary slot rows: one yes/no
        reduction per chunk over the live rows' accumulated statistics; the
        per-row ``retire`` then reads the cached verdict."""

        def review(rows):
            vsteps = self._cut_at_eos(
                rows, np.asarray([r.decoded for r in rows], np.int32),
                eos_id)
            found = self._scan_slot_rows(rows, vsteps).found.numpy()
            for i, r in enumerate(rows):
                done = (eos_id is not None
                        and bool((r.toks[: r.decoded] == eos_id).any()))
                r.meta["resolved"] = bool(found[i]) or done

        return review

    def _emit_scored_slot_rows(self, rows, steps, eos_id, results):
        """Finish binary slot rows: one batched yes/no scan over their
        decoded statistics (valid steps cut at EOS), then the result rows,
        keyed by the meta's original index."""
        vsteps = self._cut_at_eos(
            rows, np.asarray([max(1, r.decoded) for r in rows], np.int32),
            eos_id)
        res = self._scan_slot_rows(rows, vsteps)
        res_np = {k: v.numpy() for k, v in res._asdict().items()}
        for i, r in enumerate(rows):
            f3 = r.meta["first3"]
            results[int(r.meta["orig"])] = _attach_first_token(
                _result_row(*(res_np[k][i] for k in _SCAN_FIELDS), ""),
                (f3[0:1], f3[1:2], f3[2:3]), 0)

    def export_kv_slab(
        self,
        prompts: Sequence,
        targets: Sequence = ("Yes", "No"),
    ):
        """Prefill half of the KV handoff: the same prefill and position-0
        scan as :meth:`score_prompts_slotted`, but the undecided rows are
        gathered into one host :class:`~.slots.KVSlab` per prefill batch
        instead of being decoded here.

        Returns ``(rows, slabs)``: ``rows`` holds the position-0-decided
        results and ``None`` at every index that shipped out in a slab; each
        slab's metas carry ``{"orig": prompt index, "first3": ...}``.
        Decoding the slabs (:meth:`decode_kv_slabs`) gives rows bit-identical
        to decoding the same rows locally in the same ring composition
        (PARITY.md "Cross-replica KV handoff"): the round trip moves bytes,
        not values."""
        self._check_open()
        if self.is_encoder_decoder:
            raise ValueError("KV slab export is decoder-only (T5 has no "
                             "decoder-side prompt cache to hand off)")
        results: List[Optional[Dict]] = [None] * len(prompts)
        slabs: List[slots_mod.KVSlab] = []
        ids_all = self._target_id_rows(prompts, targets)
        encoded = batching.encode_prompts(self.tokenizer, list(prompts))
        for batch in self._batches(encoded):
            parts = self._select_undecided(batch, ids_all, results, 0)
            if parts is not None:
                slabs.append(slots_mod.slab_from_device(*parts))
        if slabs:
            slots_mod.slot_counter(
                "slot_slab_export_rows", sum(s.rows() for s in slabs),
                "binary", "serve")
            record_counter("slab_export_bytes",
                           sum(s.nbytes() for s in slabs))
        return results, slabs

    def decode_kv_slabs(
        self,
        slabs: Sequence,
        admit_fn: Optional[Callable] = None,
    ) -> List[Dict]:
        """Decode half of the KV handoff: import host slabs straight into a
        slot ring's pending queue and run the scored decode to retirement.

        Returns one result row per slab row in flat feed order (slabs in the
        given order, rows in each slab's meta order); the slab metas'
        ``orig`` map them back.  ``admit_fn()`` may return more slabs
        between decode chunks, as in :meth:`score_prompts_slotted`."""
        self._check_open()
        if self.is_encoder_decoder:
            raise ValueError("KV slab decode is decoder-only")
        eos_id = getattr(self.tokenizer, "eos_token_id", None)
        steps, _ = self._gen_plan()
        results: List[Optional[Dict]] = []
        ring = self._binary_ring(steps, eos_id, results)

        def feed_slab(slab):
            base = len(results)
            results.extend([None] * slab.rows())
            cache, last, lens, row_ids, metas = slots_mod.slab_to_device(
                slab, self.device)
            # re-key to local result indices; the exporter's orig stays on
            # the slab for the caller's mapping
            local = [{"orig": base + i, "first3": m["first3"]}
                     for i, m in enumerate(metas)]
            ring.feed(cache, last, lens, row_ids, local)
            slots_mod.slot_counter("slot_slab_import_rows", slab.rows(),
                                   "binary", "serve")

        def refill_hook(n_free):
            if admit_fn is None:
                return False
            more = admit_fn()
            if not more:
                return False
            for slab in more:
                feed_slab(slab)
            return True

        ring.refill_hook = refill_hook
        for slab in slabs:
            feed_slab(slab)
        ring.drain()
        # post-drain admission window, as in score_prompts_slotted
        while admit_fn is not None and refill_hook(0):
            ring.drain()
        self.record_occupancy(ring.stats)
        return [r if r is not None else _error_row("missing")
                for r in results]

    def score_packed(
        self,
        packs: Sequence,
        targets: Sequence,
        top_filter: Optional[int] = None,
    ) -> List[Dict]:
        """Packed multi-question scoring (``scoring.packed``): each pack is
        a list of ``(prompt, demo_continuation)`` segments joined into one
        row; the row prefills once and every question's yes/no
        probabilities read from the logits gathered at its anchor (the last
        token of its prompt segment, ``models.decoder.forward_anchor_logits``),
        with no decode.

        ``targets``: one (yes, no) pair, or one pair a question in
        pack-major order.  Returns one result row a question, pack-major,
        with the result fields; ``completion`` is empty, ``scan_found`` is
        the anchor's top-k membership, and the ``first_token_*`` fields read
        under ``top_filter`` (default: the engine's
        ``first_token_top_filter``).  Question 0 of a pack is isolated
        scoring; later questions move with their packed context.
        ``prefill_chunk`` does not apply here."""
        from ..scoring import packed as packed_mod

        self._check_open()
        if self.is_encoder_decoder:
            raise ValueError(
                "packed anchor scoring is decoder-only (T5 re-reads the "
                "full prompt per decoder step; there is no single prefill "
                "to gather anchors from)")
        ecfg = self.ecfg
        encoded, anchors = packed_mod.encode_packs(self.tokenizer, packs)
        n_questions = sum(len(a) for a in anchors)
        ids_all = self._target_id_rows(list(range(n_questions)), targets)
        kmax = max(len(a) for a in anchors)
        # [N, kmax] anchor offsets and flat question indices; padded slots
        # duplicate anchor 0 (consume skips them), so the gather is
        # rectangular
        anchor_arr = np.zeros((len(packs), kmax), np.int64)
        qindex = np.zeros((len(packs), kmax), np.int64)
        qvalid = np.zeros((len(packs), kmax), bool)
        qi = 0
        for i, offs in enumerate(anchors):
            for k, off in enumerate(offs):
                anchor_arr[i, k] = off
                qindex[i, k] = qi
                qvalid[i, k] = True
                qi += 1
            anchor_arr[i, len(offs):] = offs[0]
            qindex[i, len(offs):] = qindex[i, 0]
        results: List[Optional[Dict]] = [None] * n_questions
        tf = ecfg.first_token_top_filter if top_filter is None else top_filter

        def launch(batch):
            first = int(batch.indices[0])
            idx = np.where(batch.indices >= 0, batch.indices, first)
            tids = self._tensor(ids_all[qindex[idx]].reshape(-1, 2),
                                torch.int64)                 # [B*K, 2]
            logits = dmod.forward_anchor_logits(
                self.params, self.cfg,
                self._tensor(batch.token_ids, torch.int64),
                self._tensor(batch.attention_mask, torch.int32),
                self._tensor(anchor_arr[idx]))
            flat = logits.reshape(-1, logits.shape[-1])      # [B*K, V]
            scan0 = yn.first_token_scan(flat, tids[:, 0], tids[:, 1],
                                        top_k=ecfg.top_k)
            first3 = yn.relative_prob_first_token(flat, tids[:, 0],
                                                  tids[:, 1], tf)
            return _HostCopy((*scan0, *first3))

        def consume(batch, out):
            host = out.numpy()
            yes0, no0, rel0, odds0, hit0 = host[:5]
            first3 = host[5:]
            for r, orig in enumerate(batch.indices):
                if orig < 0:
                    continue
                for k in range(kmax):
                    if not qvalid[int(orig), k]:
                        continue
                    f = r * kmax + k
                    results[int(qindex[int(orig), k])] = _attach_first_token(
                        _result_row(yes0[f], no0[f], rel0[f], odds0[f],
                                    bool(hit0[f]), ""), first3, f)

        self._run_pipelined(self._batches(encoded), launch, consume,
                            rebatch=self._oom_rebatch(encoded))
        record_counter("packed_rows", len(packs))
        record_counter("packed_questions", n_questions)
        return [r if r is not None else _error_row("missing")
                for r in results]

    def packed_autoregressive_demos(
        self,
        prompts: Sequence[str],
        packing: int,
        max_demo_tokens: int = 8,
        repack: Optional[bool] = None,
        extend_stages: bool = True,
    ):
        """Auto-Demo's autoregressive demonstrations on the slot ring: each
        pack builds stage by stage, question k's demonstration being the
        model's own greedy continuation (up to ``max_demo_tokens``, cut at
        EOS) in the pack's context so far; the grown pack (demo formatted
        as ``scoring.packed.format_demo``, then the next question) re-enters
        the ring's pending queue, and a lane whose demo finished refills
        with whatever stage is ready.

        Returns ``(packs, demos)``: ``packs`` in ``build_packs`` layout,
        ready for :meth:`score_packed` (a pack's last question has no
        demo), and ``demos`` the raw continuation texts, pack-major (None
        for each pack's last question).  ``repack=False`` runs the same
        stages in whole flushes (lanes fill only when the ring is empty):
        each demo is a function of its own row, so both give the same
        texts.  ``extend_stages`` (the default): a grown pack extends its
        previous stage's prefill cache by the suffix (formatted demo and
        next question) through ``models.decoder.extend_prefill`` instead
        of prefilling the whole pack again; the stage's prefill-only cache
        stays pinned until its demo is out.  ``extend_stages=False``
        prefills every stage whole."""
        from ..scoring import packed as packed_mod

        self._check_open()
        if self.is_encoder_decoder:
            raise ValueError("packed demo decode is decoder-only")
        if packing < 1:
            raise ValueError(f"packing must be >= 1, got {packing}")
        ecfg = self.ecfg
        use_repack = ecfg.slot_repack if repack is None else bool(repack)
        eos_id = getattr(self.tokenizer, "eos_token_id", None)
        groups = [list(prompts[i: i + packing])
                  for i in range(0, len(prompts), packing)]
        first_ids = batching.encode_prompts(self.tokenizer,
                                            [g[0] for g in groups])
        later: Dict[Tuple[int, int], List[int]] = {}
        keys = [(gi, qi) for gi, g in enumerate(groups)
                for qi in range(1, len(g))]
        if keys:
            enc = self.tokenizer([groups[gi][qi] for gi, qi in keys],
                                 add_special_tokens=False)["input_ids"]
            later = {k: [int(t) for t in e] for k, e in zip(keys, enc)}
        demos: List[List[Optional[str]]] = [[None] * len(g) for g in groups]
        # stage items: (pack, question whose demo decodes next, ids so far,
        # src, suffix); src is None (prefill ids so far) or the previous
        # stage's (cache, row, prefix length), which the suffix (formatted
        # demo and next question) extends
        stage_ready: List = [
            (gi, 0, [int(t) for t in first_ids[gi]], None, None)
            for gi, g in enumerate(groups) if len(g) > 1]
        steps = max(1, int(max_demo_tokens))

        def retire(row):
            window = row.toks[: row.decoded]
            if eos_id is not None and (window == eos_id).any():
                return int(np.flatnonzero(window == eos_id)[0]) + 1
            return row.decoded if row.decoded >= steps else -1

        def emit(rows):
            for r in rows:
                gi, qi = r.meta["pack"], r.meta["question"]
                text = self._completion_text(r.toks[: r.retire_step], eos_id)
                demos[gi][qi] = text
                # the grown pack carries the formatted demo, the spelling
                # encode_packs tokenizes, so the context matches the pack
                # score_packed prefills
                demo_ids = [int(t) for t in (self.tokenizer(
                    packed_mod.format_demo(text),
                    add_special_tokens=False)["input_ids"]
                    if text else [])]
                grown = r.meta["ids"] + demo_ids
                if qi + 1 < len(groups[gi]) - 1:
                    suffix = demo_ids + list(later[(gi, qi + 1)])
                    src = r.meta.get("src") if extend_stages else None
                    if src is None or not suffix:
                        src = suffix = None
                    stage_ready.append(
                        (gi, qi + 1, grown + list(later[(gi, qi + 1)]),
                         src, suffix))

        ring = slots_mod.SlotRing(
            self, steps=steps, eos_id=eos_id,
            capacity=ecfg.phase2_pool_target or ecfg.batch_size,
            leg="packed", workload="packed", retire=retire, emit=emit,
            refill=use_repack, with_scores=False,
            pad_slice=lambda n: _pad_slice(n, max(n, 1)))

        def feed_extended(chunk):
            """Extend each item's stage cache by its suffix through
            ``extend_prefill`` and feed the ring: rows gathered source by
            source, padded to a common slot width, concatenated."""
            by_src: Dict[int, List[int]] = {}
            caches: Dict[int, dmod.KVCache] = {}
            for n, item in enumerate(chunk):
                caches[id(item[3][0])] = item[3][0]
                by_src.setdefault(id(item[3][0]), []).append(n)
            parts, order = [], []
            for key, members in by_src.items():
                idx = self._tensor([chunk[n][3][1] for n in members],
                                   torch.int64)
                parts.append(slots_mod._gather_ring_rows(caches[key], idx))
                order.extend(members)
            width = max(int(p.k.shape[2]) for p in parts)
            parts = [p if int(p.k.shape[2]) == width
                     else slots_mod._pad_cache_to(p, width) for p in parts]
            cache = slots_mod._concat_caches(parts)
            # the suffix block pads to a multiple of 8, as the reference's
            s_pad = max(8, -(-max(len(chunk[n][4]) for n in order) // 8) * 8)
            suf = np.zeros((len(order), s_pad), np.int64)
            mask = np.zeros((len(order), s_pad), np.int32)
            prefix_lens = np.asarray([chunk[n][3][2] for n in order],
                                     np.int64)
            for row, n in enumerate(order):
                sfx = chunk[n][4]
                suf[row, : len(sfx)] = sfx
                mask[row, : len(sfx)] = 1
            last, ext, total = dmod.extend_prefill(
                self.params, self.cfg, cache, self._tensor(suf),
                self._tensor(mask), self._tensor(prefix_lens))
            plen = _pool_len(int(ext.k.shape[2]))
            if plen > int(ext.k.shape[2]):
                ext = slots_mod._pad_cache_to(ext, plen)
            metas = []
            for row, n in enumerate(order):
                gi, qi, ids, _, sfx = chunk[n]
                metas.append(
                    {"pack": gi, "question": qi, "ids": ids,
                     "src": (ext, row, int(prefix_lens[row]) + len(sfx))})
            ring.feed(ext, last, total, np.zeros((len(order), 2), np.int32),
                      metas)
            slots_mod.slot_counter("slot_stage_extends", len(order),
                                   "packed", "packed")

        def prefill_stage():
            """Prefill every ready stage and feed the ring: fresh items
            (stage 0, or ``extend_stages`` off) in ordinary batches, grown
            ones through :func:`feed_extended`."""
            if not stage_ready:
                return False
            items, stage_ready[:] = list(stage_ready), []
            fresh = [it for it in items if it[3] is None]
            extends = [it for it in items if it[3] is not None]
            for batch in (self._batches([ids for _, _, ids, _, _ in fresh])
                          if fresh else ()):
                mask = self._tensor(batch.attention_mask, torch.int32)
                last, cache = self._prefill(
                    self._tensor(batch.token_ids, torch.int64), mask,
                    batch.bucket_len)
                valid = np.flatnonzero(batch.indices >= 0)
                sub, last_u, len_u = _gather_rows(
                    cache, last, mask.sum(-1), self._tensor(valid))
                plen = _pool_len(int(sub.k.shape[2]))
                if plen > int(sub.k.shape[2]):
                    sub = slots_mod._pad_cache_to(sub, plen)
                metas = []
                for j, m in enumerate(valid):
                    gi, qi, ids, _, _ = fresh[int(batch.indices[m])]
                    meta = {"pack": gi, "question": qi, "ids": ids}
                    if extend_stages:
                        meta["src"] = (sub, j,
                                       int(batch.attention_mask[m].sum()))
                    metas.append(meta)
                ring.feed(sub, last_u, len_u,
                          np.zeros((len(valid), 2), np.int32), metas)
            step = max(1, int(ecfg.batch_size))
            for at in range(0, len(extends), step):
                feed_extended(extends[at: at + step])
            return True

        # starvation hook: a freed lane pulls the next ready stage in
        # mid-decode instead of waiting for the ring to drain
        ring.refill_hook = lambda n_free: prefill_stage()
        while prefill_stage() or ring.live_rows():
            ring.drain()
        self.record_occupancy(ring.stats)
        packs = []
        for gi, g in enumerate(groups):
            pack = []
            for qi, prompt in enumerate(g):
                demo = None
                if qi + 1 < len(g) and demos[gi][qi]:
                    demo = packed_mod.format_demo(demos[gi][qi])
                pack.append((prompt, demo))
            packs.append(pack)
        return packs, [d for g in demos for d in g]

    def first_token_relative_prob(
        self, prompts: Sequence, targets: Sequence = ("Yes", "No"),
        top_filter: int = 0,
    ) -> np.ndarray:
        """One forward a batch and no generation: the position-0 (yes, no,
        relative) probabilities ``[N, 3]``, with ``top_filter`` > 0 reading
        a target outside the top-N as 0 (the sweep shell's fallback when
        the engine's ``first_token_top_filter`` is not its top-20).
        Prompts are strings or token-id sequences; ``targets`` is one pair
        or one pair per prompt."""
        self._check_open()
        ids_all = self._target_id_rows(prompts, targets)
        encoded = batching.encode_prompts(self.tokenizer, prompts)
        out = np.zeros((len(prompts), 3), np.float64)

        def launch(batch):
            ids = self._tensor(batch.token_ids, torch.int64)
            mask = self._tensor(batch.attention_mask, torch.int32)
            if self.is_encoder_decoder:
                # one decoder step from the start token
                dec = torch.full((ids.shape[0], 1),
                                 self.cfg.decoder_start_token_id,
                                 dtype=torch.int64, device=self.device)
                logits = t5mod.forward(self.params, self.cfg, ids, mask,
                                       dec)[:, 0, :]
            else:
                logits = dmod.forward_last_logits(self.params, self.cfg, ids,
                                                  mask)
            row_ids = self._tensor(self._batch_target_rows(ids_all, batch),
                                   torch.int64)
            return _HostCopy(yn.relative_prob_first_token(
                logits, row_ids[:, 0], row_ids[:, 1], top_filter))

        def consume(batch, res):
            yes, no, rel = res.numpy()
            for r, orig in enumerate(batch.indices):
                if orig >= 0:
                    out[int(orig)] = (float(yes[r]), float(no[r]),
                                      float(rel[r]))

        self._run_pipelined(self._batches(encoded), launch, consume,
                            rebatch=self._oom_rebatch(encoded))
        return out


def _binary_retire(row) -> int:
    """Slot-ring retirement of a binary scored row: it leaves its lane as
    soon as its yes/no scan is resolved (top-k hit or EOS: no later position
    can change the row), as computed once per chunk by
    ``_binary_batch_review``."""
    return row.decoded if row.meta.get("resolved") else -1


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


#: Every pooled slice is padded with inert invalid slots to the pool menu
#: entry covering its bucket, so slices of different buckets decode
#: together (with the default buckets, every bucket up to 256 pools under
#: 256 and every one from 320 to 512 under 512).
_pool_len = plan_mod.pool_len_for
#: The confidence pool holds every row, so its menu is finer.
_conf_pool_len = plan_mod.conf_pool_len_for


def _gather_rows(cache: dmod.KVCache, last, lengths, idx):
    """The look-ahead subset's rows of the prefill outputs: cache k/v (and
    an int8 cache's scales) are [L, B, T, ...] (batch axis 1); everything
    else is batch-leading."""
    return slots_mod._gather_ring_rows(cache, idx), last[idx], lengths[idx]


class _Phase2Pool:
    """Cross-batch pool of a leg's scored-decode rows.

    The scored look-ahead is bound by streaming the weights (and, in eager
    PyTorch, by launching kernels), so a step costs nearly the same for 8
    rows as for 32.  Each batch's undecided rows are gathered out of its
    prefill slice and accumulate here, keyed by quantized cache length
    (:data:`_pool_len`); decodes run over many batches' rows at once.  The
    same rows decode the same tokens from the same caches, grouped into
    fewer decodes.

    ``slot_repack=True`` (the engine's default): rows stream
    through one :class:`~.slots.SlotRing` per key, which spins up once
    ``target`` rows are pending and then refills retired lanes between
    chunks.  ``slot_repack=False``: rows accumulate to ``target`` (or until the
    pool's held bytes would pass ``max_bytes``), then one full ``steps``
    decode runs for them; it is queued and its small outputs go to the host
    through a :class:`_HostCopy`, read later in :meth:`drain`, so the launch
    loop keeps feeding the device.

    ``confidence=True`` (the confidence leg, ``leg`` names it): every row
    pools, and a row retires at the first step ``k >= 3`` whose ``k``-token
    completion can no longer change its first-integer parse
    (:meth:`_conf_retired_at`, a function of the row's own tokens only, so
    rows do not depend on the pool's composition).  On the ring a retired
    lane refills; on whole flushes the decode runs in chunks (3 positions,
    then ``scan_chunk``), compacts retired rows' K/V away between chunks
    (``completion_cache_bytes_freed``) and stops once every real row has
    retired (``conf_steps_saved``).  ``completions`` writes each row's
    completion, cut at its retirement step."""

    def __init__(self, engine, steps, eos_id, target, results,
                 max_bytes: int = 512 << 20, leg: str = "binary",
                 confidence: bool = False, completions: bool = False):
        self.engine = engine
        self.steps = steps
        self.eos_id = eos_id
        self.target = max(1, int(target))
        self.max_bytes = max(1, int(max_bytes))
        self.results = results
        self.leg = leg
        self.confidence = bool(confidence)
        self.completions = bool(completions)
        self.repack = bool(engine.ecfg.slot_repack)
        self._rings: Dict[int, slots_mod.SlotRing] = {}
        self.entries: Dict[int, List] = {}
        self.counts: Dict[int, int] = {}
        self.bytes: Dict[int, int] = {}
        # dispatched flushes awaiting their host copy:
        # [(layout, host copy, first3, [pinned bytes])]; the K/V bytes a
        # flush pins until its decode has run count against max_bytes until
        # the copy reports ready (_inflight_bytes)
        self.deferred: List = []

    def add(self, pool_len, sub_cache, last_s, len_s, n_real, orig_idx,
            row_ids, first3):
        """Queue one batch's gathered undecided slice (rows past ``n_real``
        are gather padding).  ``pool_len`` is the slice's quantized cache
        length; ``orig_idx`` the prompt index of each real row; ``row_ids``
        [m, 2] per-row (yes, no) target ids; ``first3`` [m, 3].  On the
        whole-flush schedule a key flushes when it reaches ``target`` rows
        or when the pool's held K/V would pass ``max_bytes`` (largest key
        first); an add that would push a key past the slice menu's largest
        entry flushes that key first, so a flush never exceeds the menu."""
        if self.repack:
            self._ring_add(pool_len, sub_cache, last_s, len_s, n_real,
                           orig_idx, row_ids, first3)
            return
        nb = slots_mod._cache_nbytes(sub_cache)
        # evict from the pool, largest key first (a flush moves its bytes
        # to the dispatched set, so this loop ends)...
        while self.entries and sum(self.bytes.values()) + nb > self.max_bytes:
            self.flush(max(self.bytes, key=self.bytes.get))
        # ...and only when dispatched flushes whose decode has not run yet
        # push the total past the cap, wait for them
        if self.deferred and (self._inflight_bytes()
                              + sum(self.bytes.values()) + nb > self.max_bytes):
            self.drain()
        rows = int(last_s.shape[0])
        if self.counts.get(pool_len, 0) and (
                self.counts[pool_len] + rows > _SLICE_MENU[-1]):
            self.flush(pool_len)
        self.entries.setdefault(pool_len, []).append(
            (sub_cache, last_s, len_s, int(n_real), np.asarray(orig_idx),
             np.asarray(row_ids, np.int32), np.asarray(first3)))
        self.counts[pool_len] = self.counts.get(pool_len, 0) + rows
        self.bytes[pool_len] = self.bytes.get(pool_len, 0) + nb
        if self.counts[pool_len] >= self.target:
            self.flush(pool_len)

    def flush_all(self):
        if self.repack:
            for ring in self._rings.values():
                ring.drain()
                self.engine.record_occupancy(ring.stats)
            self._rings = {}
            return
        for pool_len in list(self.entries):
            self.flush(pool_len)
        self.drain()

    # -- decode-then-repack (runtime/slots.py) ---------------------------

    def _ring_add(self, pool_len, sub_cache, last_s, len_s, n_real,
                  orig_idx, row_ids, first3):
        """Feed one batch's real rows into the ring of this quantized cache
        length, then crank it: the ring spins up once a full capacity of
        rows is pending, and from then on refills retired lanes from the
        queue between chunks."""
        if not n_real:
            return
        ring = self._rings.get(pool_len)
        if ring is None:
            ring = self._rings[pool_len] = self._make_ring()
        orig_idx = np.asarray(orig_idx)
        row_ids = np.asarray(row_ids, np.int32)
        first3 = np.asarray(first3)
        idx = self.engine._tensor(np.arange(int(n_real)), torch.int64)
        sub, last_u, len_u = _gather_rows(sub_cache, last_s, len_s, idx)
        metas = [{"orig": int(orig_idx[j]), "first3": first3[j]}
                 for j in range(int(n_real))]
        if self.confidence:
            record_counter("pooled_conf_rows", int(n_real))
        ring.feed(sub, last_u, len_u, row_ids[: int(n_real)], metas)
        ring.pump(drain=False)

    def _make_ring(self) -> slots_mod.SlotRing:
        if self.confidence:
            return slots_mod.SlotRing(
                self.engine, steps=self.steps, eos_id=self.eos_id,
                capacity=self.target, leg=self.leg, workload="engine",
                retire=self._conf_ring_retire, emit=self._conf_ring_emit,
                min_check=min(3, self.steps),
                pad_slice=lambda n: _pad_slice(n, max(n, 1)),
            )
        return slots_mod.SlotRing(
            self.engine, steps=self.steps, eos_id=self.eos_id,
            capacity=self.target, leg=self.leg, workload="engine",
            retire=_binary_retire, emit=self._binary_ring_emit,
            batch_review=self.engine._binary_batch_review(self.steps,
                                                          self.eos_id),
            pad_slice=lambda n: _pad_slice(n, max(n, 1)),
        )

    def _conf_ring_retire(self, row) -> int:
        """Retirement step of a ring row: the predicate of the whole-flush
        schedule (:meth:`_conf_retired_at`), checked over the window
        decoded since the last check, never before step 3."""
        start = max(int(row.checked), min(3, self.steps) - 1) + 1
        for k in range(start, row.decoded + 1):
            if self._conf_retired_at(row.toks, k):
                return k
        return -1

    def _binary_ring_emit(self, rows):
        self.engine._emit_scored_slot_rows(rows, self.steps, self.eos_id,
                                           self.results)

    def _conf_ring_emit(self, rows):
        """Finish retired confidence rows, batched: the fields of the
        whole-flush schedule (weighted confidence from positions 0-2, the
        yes/no scan over positions before min(r*, EOS), the completion cut
        at r*), grouped by retirement instead of by flush."""
        record_counter("pooled_conf_retired_rows",
                       sum(1 for r in rows if r.natural))
        saved = sum(self.steps - r.decoded for r in rows)
        if saved > 0:
            record_counter("conf_steps_saved", saved)
        r_star = np.asarray([max(1, r.retire_step) for r in rows], np.int32)
        self._emit_conf_rows(
            np.stack([r.toks for r in rows]), np.stack([r.vals for r in rows]),
            np.stack([r.ids_k for r in rows]),
            np.stack([r.logz for r in rows]), np.stack([r.tgt for r in rows]),
            r_star, [(i, r.meta["orig"], r.meta["first3"])
                     for i, r in enumerate(rows)])

    def _emit_conf_rows(self, toks, vals, idsk, logz, tgt, r_star, where):
        """Result rows of finished confidence rows from their per-step
        statistics ``[m, steps, ...]`` and retirement steps ``r_star``:
        ``where`` lists (row in the arrays, prompt index, first3)."""
        engine = self.engine
        ecfg = engine.ecfg
        min_conf = min(3, self.steps)
        vs = r_star.copy()
        if self.eos_id is not None:
            for g, _, _ in where:
                hits = np.flatnonzero(toks[g, : r_star[g]] == self.eos_id)
                if hits.size:
                    vs[g] = min(int(vs[g]), int(hits[0]) + 1)
        res = yn.yes_no_from_reduced(
            torch.from_numpy(vals), torch.from_numpy(logz),
            torch.from_numpy(tgt), max_look_ahead=ecfg.max_look_ahead,
            top_k=ecfg.top_k, valid_steps=torch.from_numpy(vs))
        res_np = {k: v.numpy() for k, v in res._asdict().items()}
        conf_lp = vals[:, :min_conf] - logz[:, :min_conf, None]
        conf_idx = idsk[:, :min_conf]
        for g, orig, f3 in where:
            completion = ""
            if self.completions:
                # a retired row's window never ends inside a character, so
                # this is a prefix of the full decode's completion
                completion = engine._completion_text(toks[g, : r_star[g]],
                                                     self.eos_id)
            f3 = np.asarray(f3, np.float64)
            out = _attach_first_token(
                _result_row(*(res_np[k][g] for k in _SCAN_FIELDS),
                            completion),
                (f3[0:1], f3[1:2], f3[2:3]), 0)
            out["weighted_confidence"] = conf_mod.weighted_confidence_digits(
                engine._candidates_from_topk(conf_lp[g], conf_idx[g]))
            self.results[int(orig)] = out

    def _conf_retired_at(self, toks_row, k: int) -> bool:
        """Is a confidence row's result frozen after its first ``k`` greedy
        tokens?  True when EOS landed in the window (the completion is cut
        there), when the text's first-integer parse is terminated
        (``scoring.confidence.first_int_stable``: appended text can neither
        extend its digits nor put a match before it), or when the stripped
        text already fills ``completion_chars``.  A window whose text ends
        in U+FFFD never retires: the next token may complete that byte
        sequence into a character and change the word boundaries."""
        window = toks_row[:k]
        if self.eos_id is not None and bool((window == self.eos_id).any()):
            return True
        text = self.engine.tokenizer.decode(
            [int(t) for t in window], skip_special_tokens=True)
        if text.endswith("\ufffd"):
            return False
        if len(text.strip()) >= self.engine.ecfg.completion_chars:
            return True
        return conf_mod.first_int_stable(text)

    # -- whole-flush schedule -------------------------------------------

    def _blank_entry(self, template, rows: int):
        """Numerically inert filler rows that pad a pooled decode up to a
        menu size (``slots._blank_rows`` at the entries' slot length)."""
        cache_t, last_t, len_t = template
        cache, last, lens = slots_mod._blank_rows(
            cache_t, last_t, len_t.dtype, rows, int(cache_t.k.shape[2]))
        return (cache, last, lens, 0, np.empty((0,), np.int64),
                np.zeros((rows, 2), np.int32), np.full((rows, 3), np.nan))

    def flush(self, pool_len):
        """Queue one pooled decode of every row held under ``pool_len``:
        the full ``steps`` decode and the yes/no reduction on the device,
        their [m]-sized results copied to the host behind an event.  Only
        :meth:`drain` reads them, so the launch loop is not held up by an
        early-exit check."""
        entries = self.entries.pop(pool_len, [])
        self.counts.pop(pool_len, None)
        self.bytes.pop(pool_len, None)
        if not entries:
            return
        total = sum(e[1].shape[0] for e in entries)
        m = _pad_slice(total, total if total > _SLICE_MENU[-1]
                       else _SLICE_MENU[-1])
        if m > total:
            entries.append(self._blank_entry(entries[0][:3], m - total))
        cache = slots_mod._concat_caches([e[0] for e in entries])
        last = torch.cat([e[1] for e in entries], dim=0)
        lens = torch.cat([e[2] for e in entries], dim=0)
        ids = np.concatenate([e[5] for e in entries], axis=0)     # [m, 2]
        first3 = np.concatenate([e[6] for e in entries], axis=0)  # [m, 3]
        if self.confidence:
            layout = [(int(e[1].shape[0]), e[3], e[4]) for e in entries]
            self._flush_confidence(layout, cache, last, lens, ids, first3)
            return
        engine = self.engine
        reduced = engine.ecfg.top_k <= dmod.REDUCED_TOPK
        toks, sc, _, _, _ = dmod.decode_steps(
            engine.params, engine.cfg, cache, last, lens, 0, self.steps,
            self.eos_id, None, with_scores="reduced" if reduced else True,
            target_ids=engine._tensor(ids, torch.int64) if reduced else None)
        res = engine._scan_results(sc, ids[:, 0], ids[:, 1], toks,
                                   self.eos_id)
        fields = res._asdict()
        # keep only the row layout, not the entries, whose cache slices
        # would otherwise stay referenced until drain().  Until the queued
        # decode runs, both the source slices (read by the concat) and the
        # concatenated copy are resident: 2x the slices.
        layout = [(int(e[1].shape[0]), e[3], e[4]) for e in entries]
        pinned = 2 * sum(slots_mod._cache_nbytes(e[0]) for e in entries)
        self.deferred.append((layout, list(fields), first3,
                              _HostCopy(fields.values()), [pinned]))

    def _flush_confidence(self, layout, cache, last, lens, ids, first3):
        """One pooled confidence decode with per-row retirement.

        Chunks of 3 positions, then ``scan_chunk``; after each, the greedy
        tokens come to the host and every live row's retirement step r*
        (the least k >= 3 at which :meth:`_conf_retired_at` holds) is
        resolved.  Retired rows' K/V are gathered away (menu-padded) before
        the next chunk, and the flush stops once every real row has retired.
        Against the full per-batch decode: weighted confidence (positions
        0-2) and the completion's first integer are the same by
        construction, the completion is its r*-token prefix, and the yes/no
        scan reads positions before r*."""
        engine = self.engine
        ecfg = engine.ecfg
        steps = self.steps
        K = dmod.REDUCED_TOPK
        m = sum(r for r, _, _ in layout)
        min_conf = min(3, steps)
        record_counter("pooled_conf_rows", sum(n for _, n, _ in layout))

        real = np.zeros((m,), bool)
        row = 0
        for rows, n_real, _orig in layout:
            real[row: row + n_real] = True
            row += rows
        toks_np = np.zeros((m, steps), np.int32)
        vals_np = np.zeros((m, steps, K), np.float32)
        idsk_np = np.zeros((m, steps, K), np.int32)
        logz_np = np.zeros((m, steps), np.float32)
        tgt_np = np.zeros((m, steps, 2), np.float32)
        retire_step = np.full((m,), -1, np.int32)
        checked_upto = np.full((m,), min_conf - 1, np.int32)
        decoded_upto = np.zeros((m,), np.int32)

        cache_map = np.arange(m)          # cache row -> flush-layout row
        cache_real = real.copy()          # cache row holds a live real row
        cur_cache, prev, cur_lens, done = cache, last, lens, None
        cur_ids = engine._tensor(ids, torch.int64)
        use_k = engine._k_active()
        prev_h = None                     # the K path's frontier hidden
        offset = 0
        while offset < steps:
            n = min_conf if offset == 0 else min(
                max(1, ecfg.scan_chunk), steps - offset)
            if use_k:
                # the same chunk schedule (so the same retirement points)
                # in joint K-token verify passes; blank filler rows
                # (cache_real False) never veto a pass
                toks_c, sc_c, cur_cache, prev, done, prev_h = \
                    engine._k_decode_chunk(
                        cur_cache, prev, cur_lens, offset, n, self.eos_id,
                        done, "reduced", cur_ids, prev_h, cache_real,
                        "confidence")
            else:
                toks_c, sc_c, cur_cache, prev, done = dmod.decode_steps(
                    engine.params, engine.cfg, cur_cache, prev, cur_lens,
                    offset, n, self.eos_id, done, with_scores="reduced",
                    target_ids=cur_ids)
            live = np.flatnonzero(cache_real)
            lr = cache_map[live]
            toks_np[lr, offset:offset + n] = toks_c.cpu().numpy()[live]
            vals_np[lr, offset:offset + n] = sc_c.topk_vals.cpu().numpy()[live]
            idsk_np[lr, offset:offset + n] = sc_c.topk_ids.cpu().numpy()[live]
            logz_np[lr, offset:offset + n] = sc_c.logz.cpu().numpy()[live]
            tgt_np[lr, offset:offset + n] = \
                sc_c.target_logits.cpu().numpy()[live]
            decoded_upto[lr] = offset + n
            offset += n
            if offset >= steps:
                break
            for r in lr:
                if retire_step[r] >= 0:
                    continue
                for k in range(int(checked_upto[r]) + 1, offset + 1):
                    if self._conf_retired_at(toks_np[r], k):
                        retire_step[r] = k
                        break
                checked_upto[r] = offset
            alive = [int(c) for c in live if retire_step[cache_map[c]] < 0]
            if not alive:
                break
            m2 = _pad_slice(len(alive), int(cache_map.shape[0]))
            if m2 < cache_map.shape[0]:
                # the retired rows' K/V go back to the allocator: the next
                # chunk decodes only the menu-padded live rows
                idx = np.zeros((m2,), np.int64)
                idx[: len(alive)] = alive
                freed = slots_mod._cache_nbytes(cur_cache)
                idx_dev = engine._tensor(idx)
                cur_cache, prev, cur_lens = _gather_rows(
                    cur_cache, prev, cur_lens, idx_dev)
                done = done[idx_dev]
                cur_ids = cur_ids[idx_dev]
                if prev_h is not None:    # the K frontier rides along
                    prev_h = prev_h[idx_dev]
                freed -= slots_mod._cache_nbytes(cur_cache)
                record_counter("completion_cache_bytes_freed", freed)
                cache_map = cache_map[idx]
                cache_real = np.zeros((m2,), bool)
                cache_real[: len(alive)] = True
        saved = int(np.sum(steps - decoded_upto[real]))
        if saved:
            record_counter("conf_steps_saved", saved)
        record_counter("pooled_conf_retired_rows",
                       int((retire_step[real] >= 0).sum()))

        # r*: the retirement step, or everything decoded
        r_star = np.maximum(np.where(retire_step >= 0, retire_step,
                                     decoded_upto), 1).astype(np.int32)
        where, row = [], 0
        for rows, n_real, orig in layout:
            where += [(row + j, orig[j], first3[row + j])
                      for j in range(n_real)]
            row += rows
        self._emit_conf_rows(toks_np, vals_np, idsk_np, logz_np, tgt_np,
                             r_star, where)

    def _inflight_bytes(self) -> int:
        """K/V bytes pinned by dispatched flushes whose decode has not run
        yet: a flush stops counting once its host copy reports ready (an
        event query, never a wait)."""
        total = 0
        for _layout, _names, _first3, fetched, pinned in self.deferred:
            if pinned[0] and fetched.ready():
                pinned[0] = 0
            total += pinned[0]
        return total

    def drain(self):
        """Resolve every dispatched flush into result rows."""
        for layout, names, first3, fetched, _pinned in self.deferred:
            res_np = dict(zip(names, fetched.numpy()))
            row = 0
            for rows, n_real, orig in layout:
                for j in range(n_real):
                    g = row + j
                    self.results[int(orig[j])] = _attach_first_token(
                        _result_row(*(res_np[k][g] for k in _SCAN_FIELDS),
                                    ""),
                        (first3[:, 0], first3[:, 1], first3[:, 2]), g)
                row += rows
        self.deferred = []


@torch.no_grad()
def _prefill_select(params, cfg, ids, mask, valid_rows, yes_ids, no_ids,
                    cache_len: int, slice_m: int, top_k: int,
                    top_filter: int = 20, out_len: int = 0,
                    select_all: bool = False):
    """Prefill, position-0 scan and the look-ahead's row selection.

    The selection is a stable undecided-first sort of the scan's hit mask
    (batch padding rows, ``~valid_rows``, count as decided): only a
    ``slice_m``-row slice of the cache is kept, padded with inert invalid
    slots to ``out_len`` when that exceeds ``cache_len``.  The full cache
    and the full-batch logits are dropped as soon as the slice is gathered.

    Returns (scan0, first3 [top-filtered position-0 (yes, no, relative)],
    sel [slice_m] batch row of each slice row, sub_cache, last_sel,
    len_sel).  When more than ``slice_m`` rows are undecided the caller
    must prefill again with the full cache.

    ``select_all`` (the pooled confidence leg, where every valid row takes
    the scored decode): the sort key is batch padding only, and the slice
    (``slice_m`` = the batch size) holds every valid row, first."""
    last, cache = dmod.prefill(params, cfg, ids, mask, cache_len=cache_len)
    lengths = mask.sum(-1)
    scan0 = yn.first_token_scan(last, yes_ids, no_ids, top_k=top_k)
    first3 = yn.relative_prob_first_token(last, yes_ids, no_ids, top_filter)
    decided = ~valid_rows if select_all else scan0[4] | ~valid_rows
    # argsort of an int8 key: a bool tensor has no stable sort on every
    # backend
    sel = torch.argsort(decided.to(torch.int8), stable=True)[:slice_m]
    sub = slots_mod._gather_ring_rows(cache, sel)
    last_sel, len_sel = last[sel], lengths[sel]
    del cache, last
    if out_len and out_len > cache_len:
        sub = slots_mod._pad_cache_to(sub, out_len)
    return scan0, first3, sel, sub, last_sel, len_sel


#: The yes/no scan's fields a result row takes, in ``_result_row``'s order.
_SCAN_FIELDS = ("yes_prob", "no_prob", "relative_prob", "odds_ratio", "found")


def _write_batch_rows(batch, scan0, first3, results, res_np=None,
                      base: int = 0) -> None:
    """One batch's result rows into ``results[base + prompt index]``: a row
    whose position-0 scan hit reads position 0 (``scan0``); any other reads
    the whole batch's look-ahead scan ``res_np`` at its row, or is left to
    the pool when there is none."""
    yes0, no0, rel0, odds0, hit0 = scan0
    for r, orig in enumerate(batch.indices):
        if orig < 0:
            continue
        if hit0[r]:
            vals = (yes0[r], no0[r], rel0[r], odds0[r], True)
        elif res_np is None:
            continue
        else:
            vals = tuple(res_np[k][r] for k in _SCAN_FIELDS)
        results[base + int(orig)] = _attach_first_token(
            _result_row(*vals, ""), first3, r)


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
