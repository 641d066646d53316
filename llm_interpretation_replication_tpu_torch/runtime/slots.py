"""Slot-level continuous batching: decode-then-repack (port of
``runtime/slots.py``).

A fixed-capacity ring of decode lanes where a retired lane (a resolved
binary scan, an EOS) is refilled from a pending queue between decode
chunks: the newcomer's prefilled cache row drops into the vacated lane,
padded with inert invalid slots to the ring's current cache length, while
live lanes keep decoding.

Numerics (PARITY.md "Decode-then-repack"):

- A row's decode is the same per-row math in a fresh batch, a refilled lane
  or the whole-flush path: the decode offset folds into the row's effective
  length (the ring passes ``lengths + decoded`` and ``offset = 0`` to
  ``models.decoder.decode_steps``, which places its tail at ``lengths +
  offset + i``: the positions the sequential path computes), and padding
  slots are inert (zero K/V, ``valid=False``, position 0: masked softmax
  terms are exact zeros).  Tokens, retirement points and verdicts are the
  same across ring compositions.
- Multi-chunk score fields stay in the chunked-prefill fp32 class: fold
  points and compaction gathers regroup reduction order in the last ulp.

Fragmentation, not retirement, rebuilds the cache: every chunk appends
``chunk`` tail slots to every lane, and once the slot axis outgrows
``base_len + compact_slack`` the live lanes' valid slots are compacted to
the front (content and order kept) and the axis truncated
(``slot_compactions``).

With the engine's K path active (``decode_k > 1`` and a K-head), each
chunk decodes in joint K-token verify passes
(``ScoringEngine._k_decode_chunk``); retired lanes and gather padding do not
veto a pass, and a repack drops the frontier hidden, so the next chunk
starts with a bootstrap block.

Every ``slot_*`` counter records an unlabeled twin and a
``name|leg=...,workload=...`` labeled one.

:class:`KVSlab` is the host copy of gathered, undecided cache rows that one
engine exports and another imports into its ring.  Its tensors are CPU
``torch`` tensors, not numpy arrays: numpy has no bfloat16, and a bf16
cache must round-trip bit-exactly.  A slab pins no device memory.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import to_device
from ..models import decoder as dmod
from ..utils.telemetry import record_counter
from . import strict

__all__ = ["KVSlab", "OccupancyStats", "SlotRing", "SlotRow",
           "slab_from_device", "slab_to_device", "slot_counter",
           "merge_occupancy", "occupancy_block"]


def slot_counter(name: str, value: float, leg: str, workload: str) -> None:
    """Record a ``slot_*`` counter plus its ``name|k=v`` labeled twin (keys
    sorted)."""
    record_counter(name, value)
    record_counter(f"{name}|leg={leg},workload={workload}", value)


@dataclasses.dataclass
class OccupancyStats:
    """Slot-occupancy accounting for one ring (or a merged fleet).

    ``capacity_steps`` counts the (lane x decode step) products the ring's
    chunks spent; ``live_steps`` the subset held by live real rows inside
    their decode budget.  Beside the idle fraction, the report gives the
    whole-flush counterfactual: what the same rows' retirement profile
    would have idled under the flush-at-target schedule."""

    capacity: int = 0
    rows: int = 0
    capacity_steps: int = 0
    live_steps: int = 0
    refills: int = 0
    repacks: int = 0
    compactions: int = 0
    repack_stalls: int = 0
    #: per-row decode steps actually spent (chunk-aligned retirement) --
    #: the counterfactual's input.
    row_steps: List[int] = dataclasses.field(default_factory=list)

    def idle_fraction(self) -> Optional[float]:
        if not self.capacity_steps:
            return None
        return 1.0 - self.live_steps / self.capacity_steps

    def no_repack_idle_fraction(self) -> Optional[float]:
        """Counterfactual slot-idle fraction under the whole-flush schedule:
        rows group into flushes of ``capacity`` in arrival order, each flush
        runs until its last row retires, nothing refills."""
        if not self.row_steps or not self.capacity:
            return None
        total = live = 0
        cap = max(1, self.capacity)
        for i in range(0, len(self.row_steps), cap):
            flush = self.row_steps[i: i + cap]
            dur = max(flush)
            total += cap * dur
            live += sum(flush)
        if not total:
            return None
        return 1.0 - live / total

    def merged(self, other: "OccupancyStats") -> "OccupancyStats":
        return OccupancyStats(
            capacity=max(self.capacity, other.capacity),
            rows=self.rows + other.rows,
            capacity_steps=self.capacity_steps + other.capacity_steps,
            live_steps=self.live_steps + other.live_steps,
            refills=self.refills + other.refills,
            repacks=self.repacks + other.repacks,
            compactions=self.compactions + other.compactions,
            repack_stalls=self.repack_stalls + other.repack_stalls,
            row_steps=self.row_steps + other.row_steps,
        )

    def report(self) -> Dict:
        idle = self.idle_fraction()
        before = self.no_repack_idle_fraction()
        return {
            "capacity": int(self.capacity),
            "rows": int(self.rows),
            "slot_steps": int(self.capacity_steps),
            "live_steps": int(self.live_steps),
            "slot_idle_frac": None if idle is None else round(idle, 4),
            "slot_idle_frac_no_repack": (
                None if before is None else round(before, 4)),
            "refills": int(self.refills),
            "repacks": int(self.repacks),
            "compactions": int(self.compactions),
            "repack_stalls": int(self.repack_stalls),
        }


def merge_occupancy(stats) -> Optional[OccupancyStats]:
    """Fold an iterable of :class:`OccupancyStats` into one (None when
    empty)."""
    out = None
    for s in stats:
        if s is None or not s.capacity_steps and not s.rows:
            continue
        out = s if out is None else out.merged(s)
    return out


def occupancy_block(stats: Optional[OccupancyStats]) -> Optional[Dict]:
    return None if stats is None else stats.report()


class SlotRow:
    """Host-side state of one real row travelling through the ring."""

    __slots__ = ("meta", "row_ids", "toks", "vals", "ids_k", "logz", "tgt",
                 "decoded", "checked", "retire_step", "admit_chunk",
                 "natural")

    def __init__(self, meta, row_ids, steps: int, topk: int,
                 with_scores: bool):
        self.meta = meta
        self.row_ids = row_ids                      # [2] int32 target ids
        self.toks = np.zeros((steps,), np.int32)
        if with_scores:
            self.vals = np.zeros((steps, topk), np.float32)
            self.ids_k = np.zeros((steps, topk), np.int32)
            self.logz = np.zeros((steps,), np.float32)
            self.tgt = np.zeros((steps, 2), np.float32)
        else:
            self.vals = self.ids_k = self.logz = self.tgt = None
        self.decoded = 0
        self.checked = 0          # retire_fn has inspected prefixes <= this
        self.retire_step = -1     # r*: first frozen prefix (-1 = live)
        self.admit_chunk = 0
        self.natural = False      # retired by the predicate (vs budget)


class _PendingGroup:
    """One batch's gathered rows waiting for lanes: device tensors shared,
    rows handed out by index as lanes free up."""

    __slots__ = ("cache", "last", "lens", "row_ids", "metas", "taken")

    def __init__(self, cache, last, lens, row_ids, metas):
        self.cache = cache
        self.last = last
        self.lens = lens
        self.row_ids = np.asarray(row_ids, np.int32)
        self.metas = list(metas)
        self.taken = 0

    def remaining(self) -> int:
        return len(self.metas) - self.taken


@dataclasses.dataclass
class KVSlab:
    """Host snapshot of prefilled but undecided cache rows: the unit one
    engine exports (``ScoringEngine.export_kv_slab``) and another imports
    into its ring (``decode_kv_slabs``; :meth:`SlotRing.feed` takes exactly
    these parts).

    Tensor fields are CPU tensors in the cache's own dtypes: bf16 K/V
    round-trip bit-exactly, and an int8 slab carries its codes and the
    per-head scales (the ``cache_kv_map`` layout), so the import decodes to
    the same values.  ``metas``/``row_ids``/``last``/``lens`` ride along so
    the importer can feed the ring without the prompt text; ``length`` is
    the cache's slots-filled count."""

    k: torch.Tensor                  # [L, m, T, Nkv, D]
    v: torch.Tensor
    positions: torch.Tensor          # [m, T]
    valid: torch.Tensor              # [m, T] bool
    length: int                      # slots filled (KVCache.length)
    last: torch.Tensor               # [m, V] last-position logits
    lens: torch.Tensor               # [m] real lengths
    row_ids: np.ndarray              # [m, 2] int32 yes/no target ids
    metas: List[Dict]                # per-row ring metadata
    k_scale: Optional[torch.Tensor] = None   # [L, m, T, Nkv] fp32 (int8)
    v_scale: Optional[torch.Tensor] = None

    def rows(self) -> int:
        return len(self.metas)

    def nbytes(self) -> int:
        out = int(np.asarray(self.row_ids).nbytes)
        for t in (self.k, self.v, self.positions, self.valid, self.last,
                  self.lens, self.k_scale, self.v_scale):
            if t is not None:
                out += t.numel() * t.element_size()
        return out


def slab_from_device(cache, last, lens, row_ids, metas) -> KVSlab:
    """Copy gathered ring rows into a host :class:`KVSlab`.  The copy is
    a sanctioned fetch (``runtime/strict.py``): export is an explicit
    device-to-host handoff, so strict mode's ``blocked_transfers == 0``
    holds across a slab round trip."""
    def host(t):
        return None if t is None else t.cpu()

    with strict.sanctioned_fetch():
        return KVSlab(
            k=host(cache.k), v=host(cache.v),
            positions=host(cache.positions), valid=host(cache.valid),
            length=int(cache.length), last=host(last), lens=host(lens),
            row_ids=np.asarray(row_ids, np.int32), metas=list(metas),
            k_scale=host(cache.k_scale), v_scale=host(cache.v_scale),
        )


def slab_to_device(slab: KVSlab, device):
    """``(cache, last, lens, row_ids, metas)`` -- the :meth:`SlotRing.feed`
    arguments -- from a host slab, on ``device``."""
    def put(t):
        return None if t is None else t.to(device)

    cache = dmod.KVCache(
        k=put(slab.k), v=put(slab.v), positions=put(slab.positions),
        valid=put(slab.valid),
        length=torch.tensor(slab.length, device=device),
        k_scale=put(slab.k_scale), v_scale=put(slab.v_scale),
    )
    return (cache, put(slab.last), put(slab.lens),
            np.asarray(slab.row_ids, np.int32), list(slab.metas))


def _pad_axis(t, axis: int, n: int):
    """``t`` with ``n`` zero (False) entries appended along ``axis``."""
    shape = list(t.shape)
    shape[axis] = n
    return torch.cat([t, t.new_zeros(shape)], dim=axis)


def _compact_cache_slots(cache, out_len: int):
    """Per-row slot compaction: stable-sort each row's slots valid-first
    (real slots keep their relative order, which is position order) and
    truncate the slot axis to ``out_len`` (an axis already shorter keeps its
    length).  Row contents are kept exactly; only the reduction grouping of
    the masked-zero terms moves."""
    order = torch.argsort((~cache.valid).to(torch.int8), dim=1, stable=True)
    idx = order[:, :out_len]                           # [m, min(T, out_len)]

    def take_kv(a):       # k/v [L, m, T, G, D]; scales [L, m, T, G]
        lead = idx.reshape((1,) + tuple(idx.shape) + (1,) * (a.ndim - 3))
        shape = a.shape[:2] + (idx.shape[1],) + a.shape[3:]
        return torch.gather(a, 2, lead.expand(shape))

    return dmod.cache_kv_map(
        cache, take_kv,
        positions=torch.gather(cache.positions, 1, idx),
        valid=torch.gather(cache.valid, 1, idx),
    )


def _pad_cache_to(cache, out_len: int):
    """Append inert invalid slots up to ``out_len`` (zero K/V the attention
    bias masks out; zero int8 codes decode to zero under any scale;
    ``valid=False``; position 0)."""
    pad_t = out_len - cache.k.shape[2]
    return dmod.cache_kv_map(
        cache, lambda a: _pad_axis(a, 2, pad_t),
        positions=_pad_axis(cache.positions, 1, pad_t),
        valid=_pad_axis(cache.valid, 1, pad_t),
    )


def _gather_ring_rows(cache, idx):
    return dmod.cache_kv_map(
        cache, lambda a: a[:, idx],
        positions=cache.positions[idx], valid=cache.valid[idx],
    )


def _concat_caches(parts) -> dmod.KVCache:
    first = parts[0]
    if len(parts) == 1:
        return first
    return dmod.KVCache(
        k=torch.cat([c.k for c in parts], dim=1),
        v=torch.cat([c.v for c in parts], dim=1),
        positions=torch.cat([c.positions for c in parts], dim=0),
        valid=torch.cat([c.valid for c in parts], dim=0),
        length=first.length,
        k_scale=(torch.cat([c.k_scale for c in parts], dim=1)
                 if first.k_scale is not None else None),
        v_scale=(torch.cat([c.v_scale for c in parts], dim=1)
                 if first.v_scale is not None else None),
    )


def _cache_nbytes(cache) -> int:
    """Device bytes of one cache's K/V blocks, with an int8 cache's fp32
    per-head scales."""
    n = (cache.k.numel() + cache.v.numel()) * cache.k.element_size()
    if cache.k_scale is not None:
        n += 4 * (cache.k_scale.numel() + cache.v_scale.numel())
    return n


def _blank_rows(template_cache, last_t, lens_dtype, rows: int,
                slot_len: int):
    """Numerically inert filler lanes: one valid zero-K/V slot per row (so a
    softmax never reduces over an empty set), zero logits, length 1."""
    L, _, _, G, D = template_cache.k.shape
    dev = template_cache.k.device
    kv = torch.zeros((L, rows, slot_len, G, D), dtype=template_cache.k.dtype,
                     device=dev)
    valid = torch.zeros((rows, slot_len), dtype=torch.bool, device=dev)
    valid[:, 0] = True
    # unit scales keep a quantized blank inert: zero codes decode to exact
    # zeros, as the bf16 blank's zero slots do
    scale = (torch.ones((L, rows, slot_len, G), dtype=torch.float32,
                        device=dev)
             if template_cache.k_scale is not None else None)
    cache = dmod.KVCache(
        k=kv, v=kv,
        positions=torch.zeros((rows, slot_len),
                              dtype=template_cache.positions.dtype,
                              device=dev),
        valid=valid, length=template_cache.length,
        k_scale=scale, v_scale=scale,
    )
    last = torch.zeros((rows, last_t.shape[1]), dtype=last_t.dtype,
                       device=dev)
    lens = torch.ones((rows,), dtype=lens_dtype, device=dev)
    return cache, last, lens


class SlotRing:
    """Fixed-capacity decode ring with retire-and-refill repack.

    One ring per quantized cache length.  Device state is a batched
    :class:`~..models.decoder.KVCache` plus per-lane logits, effective
    lengths and EOS flags; host state is one :class:`SlotRow` per occupied
    lane.  The loop::

        feed(...) -> pending          pump() -> [repack | decode | retire]*

    ``pump(drain=False)`` decodes only while refill work exists (live rows
    freeze between cranks so lanes never spin empty waiting for traffic);
    ``pump(drain=True)`` runs everything to retirement.

    Callbacks:

    - ``retire(row) -> int``: inspect ``row.toks[:row.decoded]`` from
      ``row.checked`` on; return the retirement step or -1.  Called between
      chunks only; a pure function of the row's own tokens keeps results
      independent of the ring's composition.
    - ``batch_review(rows)``: optional vectorized hook run before the
      per-row ``retire`` over the live rows (the binary leg's yes/no scan
      runs once per chunk there instead of once per row).
    - ``emit(rows)``: finished rows, in retirement order, batched per
      chunk.
    - ``refill_hook(n_free) -> bool``: optional starvation escape that may
      feed newly arrived work mid-decode; True when it fed any.
    """

    def __init__(self, engine, *, steps: int, eos_id, capacity: int,
                 leg: str, workload: str,
                 retire: Callable, emit: Callable,
                 batch_review: Optional[Callable] = None,
                 refill_hook: Optional[Callable] = None,
                 refill: bool = True,
                 with_scores: bool = True,
                 min_check: int = 1,
                 chunk: Optional[int] = None,
                 compact_slack: Optional[int] = None,
                 pad_slice: Optional[Callable] = None):
        self.engine = engine
        self.steps = int(steps)
        self.eos_id = eos_id
        self.capacity = max(1, int(capacity))
        self.leg = leg
        self.workload = workload
        self.retire = retire
        self.emit = emit
        self.batch_review = batch_review
        self.refill_hook = refill_hook
        self.refill = bool(refill)
        self.with_scores = bool(with_scores)
        self.min_check = max(1, int(min_check))
        scan = max(1, int(getattr(engine.ecfg, "scan_chunk", 5)))
        # uniform chunks >= min_check: every row's first window covers the
        # positions its minimum-read contract needs inside one chunk
        self.chunk = int(chunk) if chunk else max(scan, self.min_check)
        self.chunk = min(self.chunk, self.steps)
        self.compact_slack = (int(compact_slack) if compact_slack
                              else self.steps + self.chunk)
        self._pad_slice = pad_slice or (lambda n: n)
        self.stats = OccupancyStats(capacity=self.capacity)
        self._pending: List[_PendingGroup] = []
        self._finished: List[SlotRow] = []
        # device state (None until the first repack)
        self._cache = None
        self._prev = None
        self._lens = None
        self._done = None
        self._tids = None
        self._slots: List[Optional[SlotRow]] = []
        self._base_len: Optional[int] = None
        self._prev_h = None           # the K path's frontier hidden

    # -- feeding ---------------------------------------------------------

    def feed(self, cache, last, lens, row_ids, metas) -> None:
        """Queue one gathered batch of real rows ([g] leading axes; no
        padding rows -- callers gather real rows before feeding)."""
        if not len(metas):
            return
        base = int(cache.k.shape[2])
        if self._base_len is None or base > self._base_len:
            # mixed buckets may share one ring: the compaction target tracks
            # the widest prompt region fed so far (a row's valid slots never
            # exceed base + steps)
            self._base_len = base
        self._pending.append(_PendingGroup(cache, last, lens, row_ids,
                                           metas))
        self.stats.rows += len(metas)
        slot_counter("slot_rows", len(metas), self.leg, self.workload)

    def pending_rows(self) -> int:
        return sum(g.remaining() for g in self._pending)

    def live_rows(self) -> int:
        return sum(1 for s in self._slots
                   if s is not None and s.retire_step < 0)

    # -- pump ------------------------------------------------------------

    def pump(self, drain: bool = False) -> None:
        """Crank the ring: repack (drop retired lanes, refill from pending),
        decode one chunk, run retirement.  Without ``drain`` the ring pauses
        as soon as no refill work remains; live rows freeze in place until
        the next feed, so lanes only spin when there is work to backfill
        them with."""
        while True:
            if self.refill_hook is not None and not self._pending:
                self.refill_hook(self.capacity - self.live_rows())
            live, pending = self.live_rows(), self.pending_rows()
            if not live and not pending:
                break
            if not drain and not live and pending < self.capacity:
                break      # accumulate to capacity before spinning up
            if not drain and live and not pending and live < self.capacity:
                self.stats.repack_stalls += 1
                slot_counter("slot_repack_stalls", 1, self.leg,
                             self.workload)
                break
            self._repack()
            if not self.live_rows():
                break
            self._decode_chunk()
            self._retirement_scan()
            # emit per chunk, so a consumer that grows new work out of
            # finished rows feeds the pending queue in time for the next
            # repack
            self._flush_finished()
        self._flush_finished()
        if self._cache is not None and not self.live_rows():
            # every lane retired and nothing refilled: release the ring's
            # K/V instead of pinning it until the next crank
            before = self._footprint()
            self._slots = []
            self._cache = self._prev = self._lens = None
            self._done = self._tids = self._prev_h = None
            self._record_release(before)

    def drain(self) -> None:
        self.pump(drain=True)

    def _flush_finished(self) -> None:
        if self._finished:
            rows, self._finished = self._finished, []
            self.emit(rows)

    # -- repack ----------------------------------------------------------

    def _take_pending(self, n: int):
        """Pop up to ``n`` rows off the pending groups (FIFO): returns
        [(cache_sub, last_sub, lens_sub, ids, rows)] gathered per source
        group at its own slot length; :meth:`_repack` pads every part to
        the common maximum."""
        out = []
        while n > 0 and self._pending:
            g = self._pending[0]
            take = min(n, g.remaining())
            idx = np.arange(g.taken, g.taken + take, dtype=np.int64)
            dev = g.cache.k.device
            idx_dev = to_device(idx, dev)
            sub = _gather_ring_rows(g.cache, idx_dev)
            rows = [SlotRow(g.metas[j], g.row_ids[j], self.steps,
                            dmod.REDUCED_TOPK, self.with_scores)
                    for j in idx]
            out.append((sub, g.last[idx_dev], g.lens[idx_dev],
                        to_device(g.row_ids[idx], dev, torch.int64), rows))
            g.taken += take
            n -= take
            if not g.remaining():
                self._pending.pop(0)
        return out

    def _repack(self) -> None:
        """Drop retired lanes, refill from pending, re-blank the rest.

        The concat-based rebuild is the refill: live lanes are gathered
        (their decoded tails ride along), and every part -- live lanes and
        newcomers alike -- pads with inert invalid slots up to the widest
        part's slot length before the concat.  When the slot axis has
        outgrown ``base_len + compact_slack`` the live rows' slots are
        compacted valid-first first (fragmentation, never mere retirement,
        pays for the rebuild)."""
        alive_idx = [i for i, s in enumerate(self._slots)
                     if s is not None and s.retire_step < 0]
        had_state = self._cache is not None
        n_free = self.capacity - len(alive_idx)
        retired_lanes = sum(1 for s in self._slots
                            if s is not None and s.retire_step >= 0)
        will_take = ((self.refill or not alive_idx) and n_free > 0
                     and self.pending_rows() > 0)
        if had_state and not retired_lanes and not will_take \
                and not self._needs_compaction():
            return                      # nothing changed: keep lanes
        parts_cache, parts_last, parts_lens, parts_ids, rows = \
            [], [], [], [], []
        before = self._footprint()
        done_parts = []
        if alive_idx:
            idx_dev = to_device(alive_idx, self._cache.k.device,
                                torch.int64)
            sub = _gather_ring_rows(self._cache, idx_dev)
            if self._needs_compaction():
                out_len = self._base_len + self.steps
                sub = _compact_cache_slots(sub, out_len)
                self.stats.compactions += 1
                slot_counter("slot_compactions", 1, self.leg, self.workload)
            parts_cache.append(sub)
            parts_last.append(self._prev[idx_dev])
            parts_lens.append(self._lens[idx_dev])
            parts_ids.append(self._tids[idx_dev])
            done_parts.append(self._done[idx_dev])
            rows.extend(self._slots[i] for i in alive_idx)
        groups = self._take_pending(n_free) \
            if (self.refill or not alive_idx) else []
        n_new = sum(len(g[4]) for g in groups)
        for sub, last, lens, tids, grows in groups:
            parts_cache.append(sub)
            parts_last.append(last)
            parts_lens.append(lens)
            parts_ids.append(tids)
            done_parts.append(torch.zeros((len(grows),), dtype=torch.bool,
                                          device=last.device))
            rows.extend(grows)
        # common slot length = the widest part: newcomers from a longer
        # bucket pad the live lanes up, not only the other way around
        cur_len = max((int(c.k.shape[2]) for c in parts_cache),
                      default=None)
        parts_cache = [c if int(c.k.shape[2]) == cur_len
                       else _pad_cache_to(c, cur_len)
                       for c in parts_cache]
        if not rows:
            # the whole ring retired at once: every lane's K/V goes back
            self._slots = []
            self._cache = self._prev = self._lens = None
            self._done = self._tids = self._prev_h = None
            self._record_release(before)
            return
        m = self._pad_slice(len(rows))
        if m > len(rows):
            template = parts_cache[0]
            blank_c, blank_l, blank_n = _blank_rows(
                template, parts_last[0], parts_lens[0].dtype,
                m - len(rows), cur_len)
            parts_cache.append(blank_c)
            parts_last.append(blank_l)
            parts_lens.append(blank_n)
            parts_ids.append(torch.zeros((m - len(rows), 2),
                                         dtype=torch.int64,
                                         device=blank_l.device))
            done_parts.append(torch.zeros((m - len(rows),), dtype=torch.bool,
                                          device=blank_l.device))
        self._cache = _concat_caches(parts_cache)
        self._prev = torch.cat(parts_last, dim=0)
        self._lens = torch.cat(parts_lens, dim=0)
        self._tids = torch.cat(parts_ids, dim=0)
        self._done = torch.cat(done_parts, dim=0)
        # the K path's frontier hidden covers the old lanes only: the next
        # chunk's bootstrap block makes a new one
        self._prev_h = None
        self._slots = rows + [None] * (m - len(rows))
        self._record_release(before)
        self.stats.repacks += 1
        slot_counter("slot_repacks", 1, self.leg, self.workload)
        if n_new and had_state and alive_idx:
            self.stats.refills += n_new
            slot_counter("slot_refills", n_new, self.leg, self.workload)

    def _footprint(self) -> Tuple[int, int]:
        """(K/V bytes allocated, K/V bytes of the ring's rows, live or
        retired, its padding lanes left out)."""
        if self._cache is None or not self._slots:
            return 0, 0
        total = _cache_nbytes(self._cache)
        rows = sum(s is not None for s in self._slots)
        return total, total * rows // len(self._slots)

    def _record_release(self, before: Tuple[int, int]) -> None:
        """Count what a repack or the ring's release gave back against the
        :meth:`_footprint` taken ``before`` it:
        ``completion_cache_bytes_freed`` the K/V bytes actually released,
        ``completion_cache_bytes_retired`` the bytes of the rows that left.
        The reference frees a row's bytes when it leaves, shrinking the
        ring to the slice menu; these rings stay at their capacity
        (``engine._full_ring``) and release the lanes only at a
        compaction or when they empty, so the second counter is the one
        equal to the reference's ``completion_cache_bytes_freed``."""
        (freed_was, retired_was), (freed, retired) = (
            before, self._footprint())
        if freed_was > freed:
            record_counter("completion_cache_bytes_freed", freed_was - freed)
        if retired_was > retired:
            record_counter("completion_cache_bytes_retired",
                           retired_was - retired)

    def _needs_compaction(self) -> bool:
        if self._cache is None or self._base_len is None:
            return False
        return (int(self._cache.k.shape[2])
                > self._base_len + self.compact_slack)

    # -- decode + retirement --------------------------------------------

    def _real_mask(self) -> np.ndarray:
        """Lanes holding a live row (retired lanes and padding do not veto
        a K-decode pass)."""
        return np.asarray([s is not None and s.retire_step < 0
                           for s in self._slots], bool)

    def _decode_chunk(self) -> None:
        eng = self.engine
        n = self.chunk
        ws = "reduced" if self.with_scores else False
        tids = self._tids if self.with_scores else None
        if eng._k_active():
            toks_c, sc_c, self._cache, self._prev, self._done, \
                self._prev_h = eng._k_decode_chunk(
                    self._cache, self._prev, self._lens, 0, n, self.eos_id,
                    self._done, ws, tids, self._prev_h, self._real_mask(),
                    self.leg)
        else:
            toks_c, sc_c, self._cache, self._prev, self._done = \
                eng._dev.decode_steps(
                    eng.params, eng.cfg, self._cache, self._prev,
                    self._lens, 0, n, self.eos_id, self._done,
                    with_scores=ws, target_ids=tids)
        self._lens = self._lens + n
        toks_np = toks_c.cpu().numpy()
        sc_np = (tuple(f.cpu().numpy() for f in sc_c)
                 if self.with_scores else None)
        self.stats.capacity_steps += self.capacity * n
        live_now = 0
        for i, row in enumerate(self._slots):
            if row is None or row.retire_step >= 0:
                continue
            take = min(n, self.steps - row.decoded)
            if take > 0:
                row.toks[row.decoded: row.decoded + take] = \
                    toks_np[i, :take]
                if sc_np is not None:
                    vals, ids_k, logz, tgt = sc_np
                    row.vals[row.decoded: row.decoded + take] = \
                        vals[i, :take]
                    row.ids_k[row.decoded: row.decoded + take] = \
                        ids_k[i, :take]
                    row.logz[row.decoded: row.decoded + take] = \
                        logz[i, :take]
                    row.tgt[row.decoded: row.decoded + take] = tgt[i, :take]
                self.stats.live_steps += take
                live_now += take
                slot_counter("slot_live_steps", take, self.leg,
                             self.workload)
            row.decoded += take
        # idle reconciles exactly with the occupancy block:
        # capacity_steps - live_steps, per chunk
        slot_counter("slot_idle_steps",
                     max(0, self.capacity * n - live_now), self.leg,
                     self.workload)

    def _retirement_scan(self) -> None:
        live = [s for s in self._slots
                if s is not None and s.retire_step < 0]
        if self.batch_review is not None and live:
            self.batch_review(live)
        for row in live:
            r = self.retire(row)
            if r is None:
                r = -1
            row.checked = row.decoded
            row.natural = r >= 0
            if r < 0 and row.decoded >= self.steps:
                r = row.decoded            # budget exhausted: force-retire
            if r >= 0:
                row.retire_step = int(r)
                self._finished.append(row)
                self.stats.row_steps.append(row.decoded)
                slot_counter("slot_retired", 1, self.leg, self.workload)
