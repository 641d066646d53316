"""Length-bucketed batching (a copy of ``runtime/batching.py``'s
``Batch``/``bucket_for``/``batches_for_prompts``/``rebatch``/
``encode_prompts``, the fused path's ``SUFFIX_BUCKETS``/
``suffix_bucket_for``/``encode_prefix_pairs`` and the sweep shell's
``HostPrefetcher``, whose worker thread records a ``prefetch`` span).

Batches pad to a fixed menu of lengths and to a full batch of rows (pad
rows duplicate row 0 and carry index -1), so every batch has one of a few
shapes.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..config import DEFAULT_BUCKETS
from ..obs import tracer as obs
from ..utils.telemetry import record_counter


@dataclasses.dataclass
class Batch:
    token_ids: np.ndarray       # [B, S] int32, right-padded
    attention_mask: np.ndarray  # [B, S] int32
    indices: np.ndarray         # [B] original prompt index, -1 for pad rows
    bucket_len: int


def bucket_for(length: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(f"prompt length {length} exceeds the largest bucket {buckets[-1]}")


def _emit_batch(chunk, batch_size: int, bucket_len: int, pad_id: int) -> Batch:
    token_ids = np.full((batch_size, bucket_len), pad_id, np.int32)
    mask = np.zeros((batch_size, bucket_len), np.int32)
    indices = np.full((batch_size,), -1, np.int64)
    for r, (idx, ids) in enumerate(chunk):
        token_ids[r, : len(ids)] = ids
        mask[r, : len(ids)] = 1
        indices[r] = idx
    # fill pad rows with the first row so the model sees valid tokens
    for r in range(len(chunk), batch_size):
        token_ids[r] = token_ids[0]
        mask[r] = mask[0]
    return Batch(token_ids, mask, indices, bucket_len)


def batches_for_prompts(
    encoded: Sequence[Sequence[int]],
    batch_size: int,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    pad_id: int = 0,
    keep_order_within_bucket: bool = True,
    min_bucket_rows: Optional[int] = None,
    length_sorted: bool = False,
) -> Iterator[Batch]:
    """Fixed-shape padded batches for a ragged prompt list.

    ``length_sorted=True``: all prompts sort by length and consecutive runs
    of ``batch_size`` form each batch, padded to the bucket of the batch's
    longest prompt.  ``length_sorted=False``: prompts group by their own
    bucket (buckets with fewer than ``min_bucket_rows`` prompts, default
    batch_size // 8, merge into the next occupied larger bucket)."""
    if length_sorted:
        order = sorted(enumerate(encoded), key=lambda it: len(it[1]))
        for start in range(0, len(order), batch_size):
            chunk = [(idx, list(ids)) for idx, ids in order[start : start + batch_size]]
            bucket_len = bucket_for(len(chunk[-1][1]), buckets)
            yield _emit_batch(chunk, batch_size, bucket_len, pad_id)
        return
    if min_bucket_rows is None:
        min_bucket_rows = max(1, batch_size // 8)
    by_bucket: dict = {}
    for idx, ids in enumerate(encoded):
        b = bucket_for(len(ids), buckets)
        by_bucket.setdefault(b, []).append((idx, list(ids)))
    occupied = sorted(by_bucket)
    for i, b in enumerate(occupied[:-1]):
        if len(by_bucket[b]) < min_bucket_rows:
            by_bucket[occupied[i + 1]] = (
                by_bucket.pop(b) + by_bucket[occupied[i + 1]]
            )
    for bucket_len in sorted(by_bucket):
        items = by_bucket[bucket_len]
        if not keep_order_within_bucket:
            items.sort(key=lambda it: len(it[1]))
        for start in range(0, len(items), batch_size):
            yield _emit_batch(items[start : start + batch_size], batch_size,
                              bucket_len, pad_id)


def rebatch(
    batch: Batch,
    encoded: Sequence[Sequence[int]],
    batch_size: int,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    pad_id: int = 0,
    length_sorted: bool = True,
) -> List[Batch]:
    """Re-bucket one emitted batch's real rows at a smaller batch size (the
    engine's OOM back-off): the rows (``indices >= 0``) are taken again from
    ``encoded`` and re-emitted through :func:`batches_for_prompts`, with
    ``indices`` mapped back to the original prompt indices, so no row is
    lost or duplicated by the retry."""
    rows = batch.indices[batch.indices >= 0]
    sub_encoded = [encoded[int(i)] for i in rows]
    out = []
    for sb in batches_for_prompts(sub_encoded, batch_size, buckets,
                                  pad_id=pad_id, length_sorted=length_sorted):
        sb.indices = np.where(sb.indices >= 0,
                              rows[np.clip(sb.indices, 0, None)], -1)
        out.append(sb)
    return out


def encode_prompts(tokenizer, prompts: Sequence, add_special_tokens: bool = True) -> List[List[int]]:
    """Tokenize a prompt list; entries that are already token-id sequences
    (anything non-str) pass through unchanged."""
    out: List[Optional[List[int]]] = [None] * len(prompts)
    str_idx = [i for i, p in enumerate(prompts) if isinstance(p, str)]
    if str_idx:
        enc = tokenizer([prompts[i] for i in str_idx],
                        add_special_tokens=add_special_tokens)["input_ids"]
        for i, ids in zip(str_idx, enc):
            out[i] = list(ids)
    for i, p in enumerate(prompts):
        if out[i] is None:
            out[i] = [int(t) for t in p]
    return out


#: Pad-length menu of the fused path's suffix blocks (the per-leg format
#: strings appended to a shared prefix, ``engine.score_prefixed``): real
#: response and confidence formats run 8-25 tokens; anything longer rounds
#: up to a multiple of 64 instead of raising.
SUFFIX_BUCKETS = (8, 16, 24, 32, 48, 64)


def suffix_bucket_for(length: int,
                      buckets: Sequence[int] = SUFFIX_BUCKETS) -> int:
    for b in buckets:
        if length <= b:
            return b
    return -(-length // 64) * 64


def encode_prefix_pairs(
    tokenizer, pairs: Sequence,
) -> Tuple[List[List[int]], List[List[List[int]]]]:
    """Tokenize ``(prefix, suffixes)`` pairs once each for the fused
    prefix-reuse path: prefixes encode with special tokens (they open the
    prompt), suffixes without (they continue it), both memoized on their
    text, so a format string shared by every row tokenizes once a call.
    Entries that are already token-id sequences pass through.

    Returns ``(prefix_encoded[N], suffix_encoded[n_legs][N])``."""
    n_legs = len(pairs[0][1]) if pairs else 0
    memo: dict = {}

    def enc(text, special: bool) -> List[int]:
        if not isinstance(text, str):
            return [int(t) for t in text]
        key = (special, text)
        ids = memo.get(key)
        if ids is None:
            ids = memo[key] = list(tokenizer(
                [text], add_special_tokens=special)["input_ids"][0])
        return list(ids)

    prefix_encoded = []
    suffix_encoded: List[List[List[int]]] = [[] for _ in range(n_legs)]
    for prefix, suffixes in pairs:
        if len(suffixes) != n_legs:
            raise ValueError(
                f"every pair must carry {n_legs} suffixes; got "
                f"{len(suffixes)}")
        prefix_encoded.append(enc(prefix, True))
        for li, suffix in enumerate(suffixes):
            suffix_encoded[li].append(enc(suffix, False))
    return prefix_encoded, suffix_encoded


class HostPrefetcher:
    """Double-buffered host pipeline: compute ``fn(item)`` for work item
    N+1 on a background thread while the caller consumes item N (the sweep
    shell tokenizes chunk N+1 while the device scores chunk N).

    The wall time the consumer spends blocked on the worker (host work the
    overlap failed to hide) accumulates in the ``host_overlap_idle_ms``
    counter; ``host_overlap_chunks`` counts items served.  A worker
    exception re-raises in the consumer at the failed item's position.
    ``close()`` (or leaving the iterator) stops the worker and is
    idempotent; the thread is a daemon, so an abandoned prefetcher never
    holds up interpreter exit."""

    _DONE = object()

    def __init__(self, items: Iterable, fn: Callable):
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._work, args=(list(items), fn), daemon=True)
        self._thread.start()

    def _work(self, items, fn):
        try:
            for item in items:
                if self._stop.is_set():
                    return
                # tokenize/encode work on the background thread: tagged
                # host_tokenize so the phases block shows how much host
                # prep ran overlapped with device time (coverage over
                # wall-clock can exceed 1.0 because of it)
                with obs.span("prefetch", phase="host_tokenize",
                              background=True):
                    result = fn(item)
                self._put((None, result))
        # graftlint: disable=G05 producer-thread relay: the error is stored and re-raised at the consumer's get (classification still sees it there)
        except BaseException as err:
            self._put((err, None))
            return
        self._put((None, self._DONE))

    def _put(self, payload):
        while not self._stop.is_set():
            try:
                self._q.put(payload, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self):
        try:
            while True:
                t0 = time.perf_counter()
                err, result = self._q.get()
                record_counter("host_overlap_idle_ms",
                               (time.perf_counter() - t0) * 1000.0)
                if err is not None:
                    raise err
                if result is self._DONE:
                    return
                record_counter("host_overlap_chunks")
                yield result
        finally:
            # exhaustion, a consumer break or a consumer exception all stop
            # the worker
            self.close()

    @property
    def closed(self) -> bool:
        return self._stop.is_set()

    def close(self):
        """Stop the worker; later calls return at once."""
        if self._stop.is_set():
            return
        self._stop.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=1.0)
