"""In-process continuous-batching scheduler over the scoring engine (the
JAX package's ``serve/scheduler.py`` on the port's engine).

Independent :class:`~.request.ScoreRequest`\\ s land on a thread-safe
queue, coalesce into micro-batches of COMPATIBLE requests (same
:mod:`.coalescer` key: the engine's ``GenerationPlan`` cache key and
length bucket; prefix-pair requests ride ``score_prefixed`` so a shared
prefix occupies one ``PrefixCachePool`` entry per batch), launch through
the engine's entry points under a max-wait/max-batch admission policy,
and fan results back out per request as futures.

Composition with the existing layers — the scheduler goes THROUGH them,
never around them:

- **OOM** — the engine's in-place re-bucket ladder is disarmed for
  scheduler-driven launches (``engine.config_overrides(oom_backoff=False)``);
  a device OOM (``torch.OutOfMemoryError`` included, ``faults.is_oom``)
  instead splits the micro-batch down the same ladder
  (:func:`~..runtime.faults.split_for_requeue`) and the chunks RE-ENTER
  THE QUEUE with a stepped-down engine batch override, so queued traffic
  interleaves with the retry instead of stalling behind an in-engine
  retry loop.  The failed launch's tensors are dropped with its traceback
  and the allocator's cached blocks returned before the next launch, so
  the smaller batches do not split the larger one's segments under a
  memory cap.  At the floor the requests fail with the original error.
- **Transients** — scheduler launches run under
  :func:`~..runtime.faults.retry_transient` (OOM excluded, as always).
- **Strict mode** — launches go through the engine's guarded entries
  (``_run_pipelined``, the slot ring's sanctioned session), so the sync
  guard stays armed; a clean serving run is provable as
  ``blocked_transfers == 0``.
- **Telemetry** — admission, rejection, batching factor, queue-depth and
  latency distributions land in the ``serve_*`` counters/samples
  (utils/telemetry.py).
- **A mesh of ranks** — the engine's device calls are collective, and
  each rank runs its own copy of this scheduler, so every rank must make
  the same engine calls on the same inputs in the same order.  The
  decisions read the clock (the max-wait hold, deadlines, what a
  mid-decode admission finds queued), so only the mesh's leader
  (``parallel.mesh.leader``) takes them: it runs :meth:`Scheduler._loop`
  and sends each decision on the mesh's control channel
  (``parallel.mesh.decide``) before it acts on it: every engine call
  (its route, inputs and config overrides), every ``admit()`` result, an
  idle tick while it waits, and a close at shutdown.  The other ranks
  (followers) run :meth:`Scheduler._follow`: the same engine calls on the
  same inputs, their ``admit`` hooks fed from the channel; they answer
  no client.  A follower whose leader is gone ends with an error when the
  channel's timeout expires.  Under a ``model`` axis of more than one
  rank an OOM inside a forward is final (``runtime/row_parallel.py``), so
  the leader fails the micro-batch with it instead of splitting.

Thread model: ``submit`` is safe from any thread (tokenization happens on
the submitting thread); ALL engine access is serialized on the single
scheduler loop thread, so the non-thread-safe engine needs no locking.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import List, Optional

import torch

from ..obs import tracer as obs
from ..parallel import mesh as pmesh
from ..runtime import faults
from ..runtime.engine import LegSpec
from ..utils.telemetry import (
    record_counter,
    record_fault,
    record_hist,
    record_sample,
)
from . import coalescer
from .config import SchedulerConfig
from .queue import RequestQueue, Ticket
from .request import (
    DeadlineExceeded,
    QueueFull,
    SchedulerClosed,
    ScoreFuture,
    ScoreRequest,
    ServeError,
)

#: the leader's longest silence on the control channel before it sends an
#: idle tick (the channel's timeout / 4 when one is set), so that a
#: follower waiting through a quiet spell does not time out
IDLE_TICK_S = 60.0


#: Streaming latency-anatomy histograms (telemetry.record_hist — exact
#: counts, log-bucketed, NO tail truncation, unlike the serve_* sample
#: rings): per-request end-to-end latency plus its DISJOINT phase
#: decomposition, stamped at result fan-out.  The four phases sum to the
#: e2e value: queue_wait (enqueue → the admission hold opened, i.e. time
#: spent behind other traffic), coalesce (inside the max-wait hold
#: window), serve_engine (micro-batch launch → engine return, shared by
#: the group), respond (engine return → this request's future resolved).
#: A request re-queued by an OOM split attributes everything before its
#: FINAL launch to queue_wait/coalesce — the anatomy decomposes the
#: launch that produced the result.  serve/load.py reads these.
HIST_E2E = "serve_req_e2e_ms"
HIST_PHASES = {
    "queue_wait": "serve_req_queue_wait_ms",
    "coalesce": "serve_req_coalesce_ms",
    "serve_engine": "serve_req_engine_ms",
    "respond": "serve_req_respond_ms",
}


def labeled_metric(name: str, labels) -> str:
    """The ``name|k=v,k2=v2`` labeled-telemetry spelling: the telemetry
    layer keys on plain strings, and :func:`..obs.metrics.prometheus_text`
    splits this convention back into one labeled series of the base
    Prometheus family — how the EnginePool's per-replica ``serve_*``
    counters and latency histograms export as ``{replica=...,model=...}``
    series instead of N separate metric families."""
    if not labels:
        return name
    return name + "|" + ",".join(
        f"{k}={v}" for k, v in sorted(labels.items()))


def _entry_k(entry):
    """decode_k class of one slab-intake entry ``(slab, tickets,
    launch_t)`` — slabs are single-K by construction (the prefill side's
    coalescer key includes decode_k), so the first ticket speaks for
    all."""
    tickets = entry[1]
    return (getattr(tickets[0].request, "decode_k", None)
            if tickets else None)


class Scheduler:
    """Continuous-batching front door for one resident :class:`ScoringEngine`.

    Usage::

        with Scheduler(engine) as sched:
            futures = [sched.submit(ScoreRequest(prompt=p)) for p in work]
            rows = [f.result(timeout=300) for f in futures]

    ``submit`` before ``start`` queues; ``close(drain=True)`` (the
    ``with`` exit) finishes queued work, then rejects anything left with
    the typed :class:`SchedulerClosed`."""

    def __init__(self, engine, config: Optional[SchedulerConfig] = None):
        self.engine = engine
        self.config = config or SchedulerConfig()
        self.queue = RequestQueue(self.config.queue_capacity)
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._labels = dict(self.config.metric_labels or {})
        # the label suffix is constant for this scheduler's lifetime:
        # build it once, not per event in the per-request hot path
        self._label_suffix = (
            labeled_metric("", self._labels) if self._labels else "")
        #: prefill→decode slab transfer hook, installed by the EnginePool
        #: on PREFILL-role replicas (serve/pool.py): called as
        #: ``handoff(slab, tickets, launch_t)`` and returns True when a
        #: decode-role sibling accepted the slab.  None (the default)
        #: keeps every launch fully local — single-engine schedulers and
        #: symmetric pools never take the handoff branch.
        self.handoff = None
        # decode-role intake: slabs handed off BY prefill siblings, each
        # entry ``(slab, tickets, launch_t)``.  Appended from the
        # prefill replica's loop thread, drained on THIS loop thread
        # (the engine's single-thread contract), with queue.wake()
        # nudging pop_group's ready_fn probe in between.
        self._slabs: List = []
        self._slab_lock = threading.Lock()
        # on a mesh of more than one rank: the leader decides, the other
        # ranks follow (module docstring)
        mesh = getattr(engine, "mesh", None)
        self._mesh = mesh if mesh is not None and mesh.size() > 1 else None
        self.follower = (self._mesh is not None
                         and not pmesh.is_leader(self._mesh))
        self._last_sent = time.monotonic()
        self._idle_s = (pmesh._TIMEOUT[0] / 4.0 if pmesh._TIMEOUT[0]
                        else IDLE_TICK_S)
        self._follow_error: Optional[BaseException] = None
        # the engine calls this rank made, leader or follower
        self.engine_calls = 0

    # -- telemetry (labeled twin per metric when metric_labels is set) ---

    def _counter(self, name: str, value: float = 1) -> None:
        record_counter(name, value)
        if self._label_suffix:
            record_counter(name + self._label_suffix, value)

    def _sample(self, name: str, value: float) -> None:
        record_sample(name, value)
        if self._label_suffix:
            record_sample(name + self._label_suffix, value)

    def _hist(self, name: str, value: float) -> None:
        record_hist(name, value)
        if self._label_suffix:
            record_hist(name + self._label_suffix, value)

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "Scheduler":
        if self._closed:
            raise SchedulerClosed("scheduler is shut down")
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._follow if self.follower else self._loop,
                name="serve-scheduler", daemon=True)
            self._thread.start()
        return self

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Idempotent shutdown: stop admitting, drain (or abandon) queued
        work, join the loop, and sweep the engine-side audit state.  Safe
        to call twice — the drain loop and ``__exit__`` both do."""
        if self._closed:
            return
        self._closed = True
        self.queue.close()
        if self.follower:
            # a follower ends with its leader's close (or the channel's
            # error): no drain window of its own
            if self._thread is not None:
                self._thread.join()
            if self._follow_error is not None:
                raise self._follow_error
            return
        if self._thread is not None:
            self._thread.join(
                timeout if timeout is not None
                else (self.config.drain_timeout_s if drain else 1.0))
        # anything still queued after the drain window gets a typed error
        while True:
            leftover, expired = self.queue.pop_group(max_batch=1 << 30,
                                                     max_wait_s=0)
            for t in expired:
                self._reject(t, DeadlineExceeded(
                    "deadline passed before the scheduler shut down"),
                    counter="serve_rejected_deadline")
            if not leftover:
                break
            for t in leftover:
                self._reject(t, SchedulerClosed(
                    "scheduler shut down before the request launched"),
                    counter="serve_rejected_closed")
        # slabs that landed after the loop exited get a typed rejection,
        # same contract as the queued leftovers above
        with self._slab_lock:
            leftovers, self._slabs = self._slabs, []
        for _slab, tickets, _t in leftovers:
            for t in tickets:
                self._reject(t, SchedulerClosed(
                    "decode replica shut down before its handed-off slab "
                    "decoded"), counter="serve_rejected_closed")
        # the prefix pool's close() is idempotent (safe double-close): the
        # engine already closed it per call; closing again here only sweeps
        # leak accounting from a launch that died mid-flight
        pool = getattr(self.engine, "last_prefix_pool", None)
        if pool is not None:
            pool.close()

    def __enter__(self) -> "Scheduler":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)

    # -- submission ------------------------------------------------------

    def submit(self, request: ScoreRequest) -> ScoreFuture:
        """Admit one request; returns its future.  Raises the typed
        :class:`QueueFull` on backpressure and :class:`SchedulerClosed`
        after shutdown.  An already-expired deadline resolves the future
        with :class:`DeadlineExceeded` (counted, never dropped)."""
        request.validate()
        if self.follower:
            raise ServeError(
                f"a follower rank answers no client: submit on the mesh's "
                f"leader (rank {pmesh.leader(self._mesh)})")
        if self._closed:
            # typed rejection, counted like its QueueFull/DeadlineExceeded
            # siblings so the serve_rejected_* split stays complete
            self._counter("serve_rejected_closed")
            raise SchedulerClosed("scheduler is shut down")
        now = time.monotonic()
        timeout_s = (request.timeout_s if request.timeout_s is not None
                     else self.config.default_timeout_s)
        future = ScoreFuture()
        with self._seq_lock:
            self._seq += 1
            seq = self._seq
        ticket = Ticket(
            request=request, future=future, seq=seq, enqueue_t=now,
            deadline=None if timeout_s is None else now + timeout_s,
            encoded=coalescer.encode_request(self.engine, request),
            # request-scoped span correlation: the same id tags this
            # request's queue-wait span, its micro-batch's engine span,
            # and (tracing only) a trace_id field on the result row, so
            # one JSONL answer line joins back to its spans
            trace_id=f"sv-{seq}" if obs.enabled() else None,
        )
        ticket.key = coalescer.compat_key(self.engine, request,
                                          ticket.encoded)
        try:
            self.queue.put(ticket)
        except QueueFull:
            self._counter("serve_rejected_full")
            raise
        self._counter("serve_enqueued")
        self._sample("serve_queue_depth", len(self.queue))
        return future

    def submit_many(self, requests) -> List[ScoreFuture]:
        return [self.submit(r) for r in requests]

    def submit_slab(self, slab, tickets, launch_t=None) -> None:
        """Accept a handed-off KV slab (decode-role side of the
        disaggregated fleet): a PREFILL sibling's scheduler calls this —
        via the pool's handoff closure — with the slab, the tickets whose
        rows it carries (slab-meta order), and the prefill launch start
        for latency attribution.  The slab decodes on THIS scheduler's
        loop thread (the engine's single-thread contract); this call just
        enqueues and wakes the loop.  Raises :class:`SchedulerClosed`
        after shutdown so the caller can pick another sibling or decode
        locally — never silently drops."""
        with self._slab_lock:
            if self._closed:
                raise SchedulerClosed("scheduler is shut down")
            self._slabs.append((slab, tickets, launch_t))
        self._counter("serve_slab_received")
        self.queue.wake()

    # -- scheduler loop --------------------------------------------------

    def _slabs_ready(self) -> bool:
        return bool(self._slabs)

    # -- the control channel (a mesh of more than one rank) ---------------

    def _send(self, *decision) -> None:
        """Send one decision to the followers (the leader's side; nothing
        without a mesh)."""
        if self._mesh is not None:
            pmesh.decide(decision, self._mesh)
            self._last_sent = time.monotonic()

    def _tick_due(self) -> bool:
        return (self._mesh is not None
                and time.monotonic() - self._last_sent >= self._idle_s)

    def _woken(self) -> bool:
        return self._slabs_ready() or self._tick_due()

    def _engine_call(self, route: str, *args, ov=None, admit=None):
        """One engine call of ``route``, the same on the leader and on a
        follower: ``plain`` and ``prefixed`` score, ``slotted`` and
        ``slabs`` decode through the slot ring with the ``admit`` hook,
        ``export`` runs the prefill half of the KV-slab handoff."""
        self.engine_calls += 1
        eng = self.engine
        ctx = getattr(eng, "config_overrides", None)
        with (ctx(**ov) if ctx is not None and ov
              else contextlib.nullcontext()):
            if route == "plain":
                prompts, targets, conf, max_new = args
                return eng.score_prompts(prompts, targets=targets,
                                         with_confidence=conf,
                                         max_new_tokens=max_new)
            if route == "prefixed":
                pairs, targets, conf, max_new = args
                return eng.score_prefixed(
                    pairs, targets=targets,
                    legs=[LegSpec("serve", with_confidence=conf,
                                  max_new_tokens=max_new)])[0]
            if route == "slotted":
                prompts, pair_list = args
                return eng.score_prompts_slotted(prompts, targets=pair_list,
                                                 admit_fn=admit)
            if route == "export":
                prompts, pair_list = args
                return eng.export_kv_slab(prompts, targets=pair_list)
            if route == "slabs":
                slabs, = args
                return eng.decode_kv_slabs(slabs, admit_fn=admit)
        raise ValueError(f"unknown route {route!r}")

    def _follow(self) -> None:
        """A follower's loop: every engine call the leader makes, on the
        leader's inputs, until the leader's close.  Errors of an engine
        call are the leader's too (its futures carry them); an error of the
        channel itself ends the loop and :meth:`close` raises it."""

        def admit():
            kind, payload = pmesh.decide(None, self._mesh)
            if kind != "admit":
                raise ServeError(f"follower expected an admission, got "
                                 f"{kind!r} from the leader")
            return payload

        try:
            while True:
                decision = pmesh.decide(None, self._mesh)
                kind = decision[0]
                if kind == "close":
                    return
                if kind == "idle":
                    continue
                if kind != "call":
                    raise ServeError(f"follower expected an engine call, "
                                     f"got {kind!r} from the leader")
                _, route, args, ov = decision
                try:
                    self._engine_call(route, *args, ov=ov, admit=admit)
                # graftlint: disable=G05 the leader met the same error in the same call and answers its clients with it; a follower answers none
                except Exception as err:
                    if faults.is_oom(err):
                        self._release_failed_launch(err)
        # graftlint: disable=G05 a channel error ends the follower: close() raises it to the caller
        except Exception as err:
            self._follow_error = err

    def _call_route(self, route: str, *args, ov=None, admit=None):
        """The leader's engine call: its decision goes to the followers
        first, then the call runs here."""
        self._send("call", route, args, ov)
        return self._engine_call(route, *args, ov=ov, admit=admit)

    def _admitted(self, payload):
        """An ``admit()`` result, sent to the followers before the engine
        consumes it."""
        self._send("admit", payload)
        return payload

    def _loop(self) -> None:
        try:
            self._lead()
        finally:
            self._send("close")

    def _lead(self) -> None:
        while True:
            t_pop = time.monotonic()
            group, expired = self.queue.pop_group(
                self._max_batch(), self.config.max_wait_s,
                ready_fn=self._woken)
            if self._tick_due():
                self._send("idle")
            hold_start = None
            if group:
                # the admission window: how long the loop held the head
                # request open for co-batchable traffic (max-wait
                # policy).  The hold starts when there was both a loop
                # waiting AND a request to hold — max(pop start, first
                # enqueue) — NOT at pop start, which on an idle server
                # would misattribute the whole idle wait as coalescing
                hold_start = max(t_pop, min(t.enqueue_t for t in group))
                if obs.enabled():
                    obs.add_span("coalesce", hold_start, time.monotonic(),
                                 phase="serve_coalesce", batch=len(group),
                                 trace_id=group[0].trace_id)
            for t in expired:
                self._reject(t, DeadlineExceeded(
                    f"deadline passed {time.monotonic() - t.deadline:.3f}s "
                    f"before the micro-batch launched"),
                    counter="serve_rejected_deadline")
            # handed-off slabs decode BEFORE the next launch: their rows
            # are mid-request (prefill already paid elsewhere), so they
            # are the closest-to-done work this thread holds
            if self._slabs_ready():
                self._drain_slabs()
            if group is None:
                return          # closed and drained
            if group:
                self._launch(group, hold_start)

    def _max_batch(self) -> int:
        if self.config.max_batch:
            return self.config.max_batch
        ecfg = getattr(self.engine, "ecfg", None)
        return ecfg.batch_size if ecfg is not None else 32

    def _reject(self, ticket: Ticket, err: Exception,
                counter: Optional[str] = None) -> None:
        """Resolve a ticket's future with a typed error, counting
        ``counter`` only when this resolution actually WON the future's
        first-wins guard — a future already answered elsewhere (the
        pool's failover/hedging orphan legs land here) must not inflate
        the serve_rejected_*/serve_failed split."""
        if ticket.future._set_exception(err) and counter:
            self._counter(counter)

    def _engine_overrides(self, group: List[Ticket]) -> dict:
        """Per-launch EngineConfig overrides: the serve path owns OOM
        recovery (in-place ladder disarmed), split chunks carry the
        stepped-down batch size they re-entered the queue with, and a
        request-level ``decode_k`` overrides the engine's joint K-token
        decode block size for this launch (safe to read off the head
        request: the coalescer key includes the resolved decode_k, so a
        micro-batch can never mix K values)."""
        ov = {"oom_backoff": False}
        degraded = [t.degraded for t in group if t.degraded]
        if degraded:
            ov["batch_size"] = min(degraded)
        req_k = getattr(group[0].request, "decode_k", None)
        if req_k is not None:
            ov["decode_k"] = int(req_k)
        return ov

    def _finish_ticket(self, t: Ticket, row, launch_t: float,
                       done: float) -> None:
        """Resolve one ticket with its row plus the four-phase timing
        anatomy (the handoff paths' twin of ``_launch``'s inline fan-out:
        ``serve_engine`` spans the prefill launch on the EXPORTING
        replica through decode completion here — the handoff transfer is
        engine time, not respond time)."""
        if t.trace_id is not None:
            row = dict(row)
            row["trace_id"] = t.trace_id
        t_set = time.monotonic()
        timing = {
            "e2e_ms": (t_set - t.enqueue_t) * 1000.0,
            "queue_wait_ms": (t.queue_wait_s or 0.0) * 1000.0,
            "coalesce_ms": (t.coalesce_s or 0.0) * 1000.0,
            "serve_engine_ms": (done - launch_t) * 1000.0,
            "respond_ms": (t_set - done) * 1000.0,
        }
        self._hist(HIST_E2E, timing["e2e_ms"])
        self._hist(HIST_PHASES["queue_wait"], timing["queue_wait_ms"])
        self._hist(HIST_PHASES["coalesce"], timing["coalesce_ms"])
        self._hist(HIST_PHASES["serve_engine"], timing["serve_engine_ms"])
        self._hist(HIST_PHASES["respond"], timing["respond_ms"])
        t.future.timing = timing
        t.future._set_result(row)

    def _launch_handoff(self, group: List[Ticket],
                        launch_t: float) -> None:
        """Prefill-role launch (disaggregated fleet): run prefill + the
        position-0 scan HERE, resolve the decided rows, and hand each
        undecided slab to a decode-role sibling via the pool-installed
        ``handoff`` closure.  A refused handoff (no decode sibling live,
        or it closed mid-transfer) decodes the slab locally — the pool's
        always-answered contract does not depend on roster composition.

        Load accounting caveat (documented, accepted): the pool
        attributes the full e2e to THIS replica's in-flight leg — the
        decode sibling's share shows up in its own ``serve_slab_*``
        counters, not in the router's EWMA."""
        pair_list = [tuple(t.request.targets) for t in group]
        prompts = [t.encoded if t.encoded is not None
                   else t.request.prompt for t in group]
        ov = self._engine_overrides(group)
        try:
            with obs.span("serve_engine", phase="serve_engine",
                          batch=len(group), trace_id=group[0].trace_id):
                rows0, slabs = faults.retry_transient(
                    lambda: self._call_route("export", prompts, pair_list,
                                             ov=ov),
                    self.config.retry_policy, label="serve")()
        # graftlint: disable=G05 same serve fault boundary as _launch: OOM routes to the split/re-queue ladder, everything else lands typed on the futures
        except Exception as err:
            if self._may_split(err) and self._split_requeue(group, err):
                return
            self._counter("serve_failed", len(group))
            for t in group:
                self._reject(t, err)
            return
        done = time.monotonic()
        resolved = 0
        for t, row in zip(group, rows0):
            if row is None:
                continue        # rides out in a slab
            self._sample("serve_latency_ms",
                         (done - t.enqueue_t) * 1000.0)
            self._finish_ticket(t, row, launch_t, done)
            resolved += 1
        if resolved:
            self._counter("serve_completed", resolved)
        for slab in slabs:
            tickets = [group[m["orig"]] for m in slab.metas]
            if self.handoff(slab, tickets, launch_t):
                self._counter("serve_handoff_rows", len(tickets))
            else:
                self._counter("serve_handoff_local", len(tickets))
                self._decode_slabs([(slab, tickets, launch_t)])

    def _drain_slabs(self) -> None:
        """Decode every slab the intake holds, one launch per decode_k
        class (a micro-batch must never mix K values — the same rule the
        coalescer key enforces on the prefill side)."""
        while True:
            with self._slab_lock:
                batch, self._slabs = self._slabs, []
            if not batch:
                return
            by_k = {}
            for entry in batch:
                by_k.setdefault(_entry_k(entry), []).append(entry)
            for entries in by_k.values():
                self._decode_slabs(entries)

    def _decode_slabs(self, entries) -> None:
        """Decode handed-off slabs on the loop thread (decode-role side).
        The engine's ``admit_fn`` hook pulls same-K slabs that land
        MID-DECODE straight into vacated ring lanes, so a decode
        replica's lanes refill from the fleet's handoff stream without
        draining first."""
        now = time.monotonic()
        k_val = _entry_k(entries[0])
        flat: List = []

        def note(batch):
            out = []
            for slab, tickets, launch_t in batch:
                out.append(slab)
                lt = launch_t if launch_t is not None else now
                flat.extend((t, lt) for t in tickets)
            return out

        slabs = note(entries)
        base_n = len(flat)
        admitted_entries: List = []

        def admit():
            with self._slab_lock:
                more = [e for e in self._slabs if _entry_k(e) == k_val]
                for e in more:
                    self._slabs.remove(e)
            if not more:
                return self._admitted(None)
            admitted_entries.extend(more)
            self._counter("serve_slab_admitted", len(more))
            return self._admitted(note(more))

        def call():
            if admitted_entries:
                # transient RETRY: the re-invoked decode feeds only the
                # original slabs, so a previous attempt's admissions go
                # back to the intake (same reasoning as the slotted
                # launch's requeue)
                with self._slab_lock:
                    self._slabs[:0] = admitted_entries
                admitted_entries.clear()
                del flat[base_n:]
            return self._call_route("slabs", slabs, ov=ov, admit=admit)

        ov = self._engine_overrides([t for t, _ in flat])
        try:
            with obs.span("serve_engine", phase="serve_engine",
                          batch=len(flat), trace_id=flat[0][0].trace_id):
                rows = faults.retry_transient(
                    call, self.config.retry_policy, label="serve")()
        # graftlint: disable=G05 same serve fault boundary as _launch: the slab rows' errors land typed on each request's future, nothing re-raises above the loop thread
        except Exception as err:
            self._counter("serve_failed", len(flat))
            for t, _ in flat:
                self._reject(t, err)
            return
        done = time.monotonic()
        for (t, lt), row in zip(flat, rows):
            self._sample("serve_latency_ms",
                         (done - t.enqueue_t) * 1000.0)
            self._finish_ticket(t, row, lt, done)
        self._counter("serve_completed", len(flat))

    def _launch(self, group: List[Ticket],
                hold_start: Optional[float] = None) -> None:
        now = time.monotonic()
        self._counter("serve_batches")
        self._counter("serve_batch_rows", len(group))
        if hold_start is None:
            hold_start = now
        for t in group:
            self._sample("serve_queue_wait_ms",
                          (now - t.enqueue_t) * 1000.0)
            # latency-anatomy stamps (HIST_PHASES): the pre-launch wait
            # splits into DISJOINT queue_wait (behind other traffic,
            # before the admission hold opened) and coalesce (inside the
            # hold window) — the head request is all coalesce, a
            # late-arriving co-batched one all coalesce too, a request
            # that sat behind an earlier launch mostly queue_wait
            t.coalesce_s = max(0.0, now - max(hold_start, t.enqueue_t))
            t.queue_wait_s = max(0.0, (now - t.enqueue_t) - t.coalesce_s)
            if t.trace_id is not None and obs.enabled():
                # cross-thread span: enqueue happened on the submitting
                # thread, the pop on this loop thread — manually timed
                obs.add_span("queue_wait", t.enqueue_t, now,
                             phase="serve_queue_wait", trace_id=t.trace_id)
        first = group[0].request
        pair_list = [tuple(t.request.targets) for t in group]
        targets = (list(first.targets) if len(set(pair_list)) == 1
                   else pair_list)
        admitted: List[Ticket] = []
        ov = self._engine_overrides(group)

        if self.handoff is not None and self._slotted_eligible(first):
            # prefill-role replica of a disaggregated roster: the slotted
            # contract holding is exactly what makes the rows
            # slab-exportable (scored binary decode, no prefix pair, no
            # confidence leg)
            self._launch_handoff(group, now)
            return

        if self._slotted_eligible(first):
            # slot-level continuous batching (runtime/slots.py): the
            # micro-batch decodes through the slot ring, and the ring's
            # starvation hook pulls freshly-queued COMPATIBLE requests
            # into vacated slots MID-DECODE — admission stops being a
            # coalescer-boundary event.  Results come back in feed order
            # (group first, admitted appended).
            key = group[0].key
            prompts = [t.encoded if t.encoded is not None
                       else t.request.prompt for t in group]

            def admit():
                # bounded admission: at most one extra micro-batch worth
                # of rows joins a launch — an unbounded window under
                # sustained compatible load would keep this launch alive
                # forever, starving every OTHER key's traffic (and the
                # deadline sweep) behind the single loop thread
                budget = self._max_batch() - len(admitted)
                if budget <= 0:
                    return self._admitted(None)
                extra = self.queue.pop_compatible(key, budget)
                if not extra:
                    return self._admitted(None)
                t_adm = time.monotonic()
                for t in extra:
                    t.queue_wait_s = max(0.0, t_adm - t.enqueue_t)
                    t.coalesce_s = 0.0
                self._counter("serve_slot_admitted", len(extra))
                admitted.extend(extra)
                return self._admitted(
                    ([t.encoded if t.encoded is not None
                      else t.request.prompt for t in extra],
                     [tuple(t.request.targets) for t in extra]))

            def call():
                if admitted:
                    # transient RETRY: the re-invoked session feeds only
                    # the original prompts, so a previous attempt's
                    # admissions must re-enter the queue (original seq
                    # kept — they sort ahead of newer traffic) or their
                    # futures would be zipped against the wrong rows /
                    # never resolved
                    self.queue.requeue(list(admitted))
                    admitted.clear()
                return self._call_route("slotted", prompts, pair_list,
                                        ov=ov, admit=admit)
        elif first.prefix is not None:
            pairs = [
                (t.encoded[0], (t.encoded[1],)) if t.encoded is not None
                else (t.request.prefix, (t.request.suffix,))
                for t in group
            ]

            def call():
                return self._call_route("prefixed", pairs, targets,
                                        first.with_confidence,
                                        first.max_new_tokens, ov=ov)
        else:
            prompts = [t.encoded if t.encoded is not None
                       else t.request.prompt for t in group]

            def call():
                return self._call_route("plain", prompts, targets,
                                        first.with_confidence,
                                        first.max_new_tokens, ov=ov)

        try:
            with obs.span("serve_engine", phase="serve_engine",
                          batch=len(group), trace_id=group[0].trace_id):
                rows = faults.retry_transient(
                    call, self.config.retry_policy, label="serve")()
        # graftlint: disable=G05 serve fault boundary: the error IS classified (faults.is_oom routes to the split/re-queue ladder) and everything else lands typed on each request's future — nothing above the scheduler thread could observe a re-raise
        except Exception as err:
            # slot-admitted tickets ride the SAME recovery as the group
            # they joined: an OOM re-queues everyone down the ladder,
            # anything else lands typed on every participating future
            group = group + admitted
            if self._may_split(err) and self._split_requeue(group, err):
                return
            self._counter("serve_failed", len(group))
            for t in group:
                self._reject(t, err)
            return
        done = time.monotonic()
        engine_s = done - now
        group = group + admitted        # slotted results ride feed order
        for t, row in zip(group, rows):
            self._sample("serve_latency_ms", (done - t.enqueue_t) * 1000.0)
            if t.trace_id is not None:
                # measurement-only: the trace id rides the answer row so
                # a JSONL output line joins back to its spans; replay
                # parity ignores the key (serve/replay.rows_equal)
                row = dict(row)
                row["trace_id"] = t.trace_id
            # per-request latency anatomy: four disjoint phases summing
            # to e2e, streamed into the exact-count histograms and
            # attached to the FUTURE (never the row — bit-parity)
            t_set = time.monotonic()
            respond_s = t_set - done
            timing = {
                "e2e_ms": (t_set - t.enqueue_t) * 1000.0,
                "queue_wait_ms": (t.queue_wait_s or 0.0) * 1000.0,
                "coalesce_ms": (t.coalesce_s or 0.0) * 1000.0,
                "serve_engine_ms": engine_s * 1000.0,
                "respond_ms": respond_s * 1000.0,
            }
            self._hist(HIST_E2E, timing["e2e_ms"])
            self._hist(HIST_PHASES["queue_wait"], timing["queue_wait_ms"])
            self._hist(HIST_PHASES["coalesce"], timing["coalesce_ms"])
            self._hist(HIST_PHASES["serve_engine"],
                        timing["serve_engine_ms"])
            self._hist(HIST_PHASES["respond"], timing["respond_ms"])
            t.future.timing = timing
            t.future._set_result(row)
        self._counter("serve_completed", len(group))
        if obs.enabled():
            obs.add_span("respond", done, time.monotonic(),
                         phase="serve_respond", batch=len(group),
                         trace_id=group[0].trace_id)

    def _slotted_eligible(self, first) -> bool:
        """Slot-level admission engages only where its contract holds:
        the pooled binary scored path (no prefix pair, no confidence
        leg, engine without completion decoding, decoder-only engine)
        and the knob on.  Everything else keeps the coalescer-boundary
        launch — including every configuration whose replay contract
        pins BIT parity with offline scoring."""
        if not self.config.slot_admission:
            return False
        if first.prefix is not None or first.with_confidence:
            return False
        ecfg = getattr(self.engine, "ecfg", None)
        if ecfg is None or ecfg.decode_completions:
            return False
        if getattr(self.engine, "is_encoder_decoder", False):
            return False
        return hasattr(self.engine, "score_prompts_slotted")

    def _may_split(self, err) -> bool:
        """An OOM the split/re-queue ladder may take: not under a ``model``
        axis of more than one rank, where an OOM inside a forward is final
        (the other model ranks wait in its collectives; a retry would pair
        with them).  The micro-batch's requests fail with it."""
        if not faults.is_oom(err):
            return False
        return pmesh.axis_size(self._mesh, pmesh.MODEL_AXIS) == 1

    def _split_requeue(self, group: List[Ticket], err) -> bool:
        """OOM recovery: split the micro-batch down the engine's ladder
        and push the chunks BACK INTO THE QUEUE (never an in-engine retry)
        at a stepped-down engine batch size.  False at the floor — the
        caller propagates ``err`` to the futures."""
        ecfg = getattr(self.engine, "ecfg", None)
        current = min(t.degraded for t in group if t.degraded) \
            if any(t.degraded for t in group) else (
                ecfg.batch_size if ecfg is not None else len(group))
        ladder = self.config.oom_ladder or (
            ecfg.oom_batch_ladder if ecfg is not None else ())
        split = faults.split_for_requeue(len(group), current,
                                         ladder=ladder,
                                         floor=self.config.oom_floor)
        if split is None:
            return False
        new_batch, sizes = split
        self._counter("serve_oom_splits")
        record_fault("serve_oom_split", rows=len(group), batch=current,
                     new_batch=new_batch, error=faults.oom_detail(err))
        print(f"# serve: device OOM at batch {current}; re-queueing "
              f"{len(group)} rows as {len(sizes)} micro-batch(es) at "
              f"batch {new_batch} [{faults.oom_detail(err)}]",
              file=sys.stderr)
        offset = 0
        for size in sizes:
            chunk = group[offset: offset + size]
            offset += size
            for t in chunk:
                t.degraded = new_batch
            self.queue.requeue(chunk)
        self._release_failed_launch(err)
        return True

    def _release_failed_launch(self, err) -> None:
        """Return the failed launch's memory before the split chunks run:
        its tensors live on in the frames of ``err``'s traceback, and the
        allocator keeps their blocks cached, cut to the larger batch's
        sizes — smaller launches would split them, and split segments
        cannot be released again under a memory cap."""
        err.__traceback__ = None
        device = getattr(self.engine, "device", None)
        if getattr(device, "type", None) == "cuda":
            torch.cuda.empty_cache()
