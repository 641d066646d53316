"""EnginePool: a multi-replica serving fleet behind one front door (the
JAX package's ``serve/pool.py`` on the port's engine).

N :class:`~..runtime.engine.ScoringEngine` replicas — N copies of one
model, or N distinct models (the instruct-sweep roster) — served through
ONE front door, with hot load/unload and vendor backends riding the same
router as local replicas.  The pool is measured through the SAME
open-loop harness as the single-engine scheduler (:mod:`.load`), so
replica count becomes an axis of the latency-anatomy curve.

Composition — the pool goes THROUGH the existing layers, never around
them:

- each LOCAL replica is an ordinary :class:`~.scheduler.Scheduler` over
  its own engine: coalescing, the OOM split/re-queue ladder, strict-mode
  sync guards, and the latency-anatomy histograms all keep working
  per replica, and the pool stamps ``{replica, model}`` metric labels
  (:func:`~.scheduler.labeled_metric`) so the ``serve_*`` families
  export per-replica series next to the fleet aggregate;
- REMOTE replicas (:class:`RemoteBackend`) adapt a vendor ``evaluate``
  callable to the same result-row contract and the same router, with
  per-request cost estimated from :mod:`..api_backends.cost` pricing and
  observed latency folded into the routing score;
- hot unload rides :meth:`~..runtime.engine.ScoringEngine.close` (the
  weights' storages are freed in place and the allocator's cache
  returned), so loading a DIFFERENT model into the same process is an
  ordinary ``load()``.

Routing: ``submit`` lands the request on its model's FIFO queue; the
dispatcher moves it to the least-loaded compatible replica (smallest
predicted wait = observed-latency EWMA x (1 + outstanding), plus the
cost term for remote backends).  A replica mid-drain is never selected;
a request that a closing replica bounces (typed ``SchedulerClosed``)
re-enters its model queue and is re-dispatched — the pool's
always-answered contract: every admitted request resolves with a row or
a typed error, never silently dropped.

Disaggregation: replicas loaded with ``role="prefill"``/``role="decode"``
split the phases across the fleet — prefill specialists run prefill and
the position-0 scan and ship undecided rows' int8/bf16 KV slabs
(:class:`~..runtime.slots.KVSlab`, host tensors) to decode specialists,
whose slot rings import them mid-flight.  The router's role affinity
keeps fresh prompts off decode replicas unless nothing else is live.

Replicas on rank slices: ``load(..., devices=slice)`` with a slice of
:func:`~..parallel.mesh.carve_slices` binds the replica's engine to
``make_mesh(data=len(slice), devices=slice)``, as the reference binds it
to a device slice.  One process a rank (``torchrun``): every rank builds
the pool and loads every replica in the same order (the slices' groups
are made collectively), and a rank hosts the replicas whose slice holds
it.  World rank 0 is the pool's leader: it alone takes requests and
routes them.  A replica whose slice holds rank 0 serves in its process;
one on other ranks is a :class:`SliceReplica` there, whose requests go
to the slice's first rank on a gloo pair group and whose rows come back
on another (:class:`_SliceServer` on that rank); inside a slice of more
than one rank the slice's first rank leads its scheduler and the others
follow (serve/scheduler.py).  With fewer ranks than slices every slice is
the whole world, the reference's shared placement: on a world of one
rank (one card) the replicas share it.  A prefill replica hands its KV
slabs only to a decode sibling in its own process; one on another slice
decodes them itself.  Supervision (``supervise``) is for a pool in one
process: its rebuild of a replica on slices of a world of ranks would
make the slice's groups on one rank alone.

Remote backends work in full, cost routing included: the vendor
constructors :meth:`RemoteBackend.openai` / ``gemini`` / ``anthropic``
over the port's API clients, or ``RemoteBackend(model, evaluate)`` over
an injected callable.

Measurement-only routing (PARITY.md): the pool changes WHERE and WHEN a
row is computed, never WHAT — local replica rows are bit-identical to
the same engine's offline ``score_prompts``.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import queue as queue_mod
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..parallel import mesh as pmesh
from ..utils.telemetry import record_counter
from .config import SchedulerConfig
from .request import (
    DeadlineExceeded,
    QueueFull,
    SchedulerClosed,
    ScoreFuture,
    ScoreRequest,
    ServeError,
)
from .scheduler import IDLE_TICK_S as LINK_IDLE_S
from .scheduler import Scheduler
from .supervisor import ReplicaSupervisor, SupervisorConfig

#: router reap tick while work is IN FLIGHT: replica futures resolve on
#: replica threads that cannot signal the pool's condition, so completion
#: detection polls at this cadence (the per-hop latency floor it adds).
DISPATCH_TICK_S = 0.002

#: router tick while the pool is IDLE (nothing queued, nothing in
#: flight): submits/loads/unloads/close all signal the condition, so the
#: coarse tick only bounds how stale the deadline sweep of an orphaned
#: queue can get — a quiet serving process wakes ~4x/s, not ~500x.
IDLE_TICK_S = 0.25

#: observed-latency EWMA smoothing per replica (e2e seconds).
LATENCY_EWMA_ALPHA = 0.2

#: predicted-wait floor: before a replica has any observed latency its
#: EWMA is this, so the load term (1 + outstanding) still differentiates
#: two cold replicas instead of scoring both 0.
LATENCY_FLOOR_S = 1e-3


class PoolClosed(ServeError):
    """The pool shut down before (or while) the request could run."""


class UnknownModel(ServeError):
    """``submit`` named a model no replica serves (and none ever did)."""


@dataclasses.dataclass
class PoolConfig:
    """Router/backend-selection knobs.  ``scheduler`` is the TEMPLATE for
    every local replica's :class:`~.config.SchedulerConfig` — the pool
    copies it per replica and stamps the ``{replica, model}`` metric
    labels on each copy."""

    scheduler: Optional[SchedulerConfig] = None
    #: backend-selection weights: a replica's routing score is
    #: ``latency_weight * predicted_wait_s + cost_weight * cost_usd *
    #: cost_scale_s_per_usd``.  Local replicas cost $0, so with
    #: ``cost_weight`` dominant the router prefers local capacity and
    #: spills to vendors only when local queues grow; with
    #: ``latency_weight`` dominant it chases the fastest observed
    #: backend regardless of price.
    cost_weight: float = 0.5
    latency_weight: float = 0.5
    #: USD -> seconds exchange rate of the routing score (how many
    #: seconds of predicted wait one dollar of vendor spend is worth).
    cost_scale_s_per_usd: float = 1000.0
    #: close(drain=True) gives queued + in-flight work this long before
    #: leftovers fail with the typed :class:`PoolClosed`.
    drain_timeout_s: float = 120.0
    #: a replica whose oldest queued request has waited this long reads
    #: ``degraded`` in :meth:`EnginePool.health` (0 disables; falls back
    #: to the scheduler template's ``health_max_queue_age_s``).
    health_max_queue_age_s: float = 0.0
    #: fleet self-healing (serve/supervisor.py): None (default) keeps
    #: the pool report-only — replica failures propagate to callers
    #: exactly as before this layer existed.  A
    #: :class:`~.supervisor.SupervisorConfig` arms crash/wedge
    #: detection, quarantine + rebuild, in-flight failover, hedging,
    #: and vendor circuit breakers.
    supervision: Optional[SupervisorConfig] = None


@dataclasses.dataclass
class _PoolTicket:
    """One admitted request travelling through the pool router."""

    request: ScoreRequest
    future: ScoreFuture
    model: str
    enqueue_t: float
    seq: int = 0                    # admission order (FIFO tie-break)
    deadline: Optional[float] = None  # absolute monotonic, None = never
    replica_future: Optional[ScoreFuture] = None
    replica: Optional["_BaseReplica"] = None
    dispatch_t: Optional[float] = None
    #: supervision bookkeeping (serve/supervisor.py): failed-over hops,
    #: replicas this request's leg took down (the poison-row ceiling),
    #: and the optional tail-latency hedge leg.  Rides the TICKET, never
    #: the request or the row — replay bit-parity never sees it.
    failovers: int = 0
    kills: int = 0
    hedge_future: Optional[ScoreFuture] = None
    hedge_replica: Optional["_BaseReplica"] = None

    def sort_key(self):
        return (-self.request.priority, self.seq)

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline


class ParamShareGroup:
    """Refcounted ownership of ONE param tree shared by sibling
    replicas (the bench/CLI fleet over a single snapshot): each
    sibling's teardown releases a reference, and only the LAST release
    reports that the shared buffers may be deleted — so hot-unloading
    the siblings in ANY order never deletes buffers a survivor still
    scores through."""

    def __init__(self, count: int):
        self._count = max(1, int(count))
        self._lock = threading.Lock()

    def acquire_one(self) -> None:
        """Add one reference (a rebuilt sibling joining the group after
        a quarantine, serve/supervisor.py)."""
        with self._lock:
            self._count += 1

    def release_one(self) -> bool:
        """True exactly once: on the release that drops the last ref."""
        with self._lock:
            self._count -= 1
            return self._count == 0


class _BaseReplica:
    """Shared replica surface: identity, lifecycle state, load/latency
    accounting the router scores on."""

    kind = "local"

    def __init__(self, rid: str, model: str,
                 role: Optional[str] = None):
        self.rid = rid
        self.model = model
        #: disaggregation role: None = general (serves
        #: everything), "prefill" = runs prefill + position-0 scan and
        #: hands undecided KV slabs off, "decode" = imports slabs into
        #: its slot ring; fresh prompts route to it only when no
        #: prefill/general sibling is live (always-answered beats role
        #: purity).
        self.role = role
        self.state = "live"            # live | draining | closed
        self.outstanding = 0           # dispatched, not yet resolved
        self.completed = 0
        self.failed = 0
        self.latency_ewma_s = 0.0

    # -- router accounting ----------------------------------------------

    def note_latency(self, e2e_s: float) -> None:
        if self.latency_ewma_s <= 0.0:
            self.latency_ewma_s = e2e_s
        else:
            self.latency_ewma_s += LATENCY_EWMA_ALPHA * (
                e2e_s - self.latency_ewma_s)

    def predicted_wait_s(self) -> float:
        est = max(self.latency_ewma_s, LATENCY_FLOOR_S)
        return est * (1.0 + self.outstanding + self.queue_depth())

    def cost_estimate_usd(self, request: ScoreRequest) -> float:
        return 0.0

    def queue_depth(self) -> int:
        return 0

    def oldest_wait_s(self) -> Optional[float]:
        return None

    def health(self, max_age_s: float) -> Dict:
        doc = {
            "replica": self.rid,
            "model": self.model,
            "kind": self.kind,
            "state": self.state,
            "queue_depth": self.queue_depth(),
            "outstanding": self.outstanding,
            "completed": self.completed,
            "failed": self.failed,
            "latency_ewma_ms": round(self.latency_ewma_s * 1000.0, 3),
        }
        if self.role is not None:
            doc["role"] = self.role
        age = self.oldest_wait_s()
        if age is not None:
            doc["oldest_wait_s"] = round(age, 3)
            if max_age_s and age > max_age_s:
                doc["status"] = "degraded"
                doc["degraded_reason"] = (
                    f"oldest queued request has waited {age:.1f}s "
                    f"(> {max_age_s:g}s threshold)")
        return doc


def _world() -> tuple:
    """(rank, world size) of this process (0, 1 without a process
    group)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


class LocalReplica(_BaseReplica):
    """One resident :class:`ScoringEngine` behind its own
    :class:`Scheduler`.  ``owns_engine`` controls whether unload calls
    ``engine.close(release_params=True)``: replicas sharing one param
    tree (bench fleets over a single snapshot) release buffers only when
    the LAST sibling unloads.

    ``devices`` (ranks: a slice of :func:`~..parallel.mesh.carve_slices`)
    binds the replica's engine to ``make_mesh(data=len(devices),
    devices=devices)`` before its scheduler starts, as the reference
    binds it to a device slice.  Every rank of the world constructs the
    replica (the mesh's groups are made collectively); a rank outside the
    slice holds it unhosted (``hosted`` False, no scheduler).  The slice's
    first rank leads the scheduler.  A slice of the whole world is the
    shared placement (``placement`` in the health doc); without a process
    group (one rank) the engine stays unbound."""

    def __init__(self, rid: str, model: str, engine,
                 config: SchedulerConfig, owns_engine: bool = True,
                 plan_note: Optional[str] = None,
                 share_group: Optional[ParamShareGroup] = None,
                 role: Optional[str] = None,
                 devices=None):
        super().__init__(rid, model, role=role)
        self.engine = engine
        self.owns_engine = owns_engine
        self.share_group = share_group
        self.plan_note = plan_note
        self.devices = None if devices is None else tuple(
            int(d) for d in devices)
        self.placement = None
        self.hosted = True
        #: the slice's request server (on its first rank, when the pool's
        #: leader is another rank)
        self.server = None
        if self.devices is not None:
            rank, world = _world()
            self.placement = ("shared" if len(self.devices) >= world
                              else "sliced")
            if self.placement == "shared" and world > 1:
                raise ValueError(
                    f"replica {rid}: {len(self.devices)} ranks for a world "
                    f"of {world}: replicas sharing more than one rank "
                    f"would interleave their collectives; carve the world "
                    f"into slices (parallel.mesh.carve_slices)")
            if world > 1:
                mesh = pmesh.make_mesh(data=len(self.devices),
                                       devices=self.devices)
                self.hosted = rank in self.devices
                if self.hosted:
                    engine.bind_mesh(mesh)
        self.scheduler = None
        if self.hosted:
            cfg = dataclasses.replace(
                config, metric_labels={**(config.metric_labels or {}),
                                       "replica": rid, "model": model})
            self.scheduler = Scheduler(engine, cfg).start()

    def dispatch(self, ticket: _PoolTicket) -> ScoreFuture:
        return self.scheduler.submit(ticket.request)

    def queue_depth(self) -> int:
        return len(self.scheduler.queue)

    def oldest_wait_s(self) -> Optional[float]:
        return self.scheduler.queue.oldest_wait_s()

    def shutdown(self, drain: bool = True,
                 release_params: Optional[bool] = None) -> None:
        """Drain the scheduler, then tear the engine down
        (:meth:`ScoringEngine.close` — verified buffer release).  A
        replica in a :class:`ParamShareGroup` releases the shared tree
        only when it is the LAST sibling to shut down, whatever the
        unload order.  A slice's first rank first waits for the pool
        leader's close (its request server); a follower rank, for its
        scheduler's leader."""
        self.state = "closed"
        if self.server is not None:
            self.server.join()
        self.scheduler.close(drain=drain)
        close = getattr(self.engine, "close", None)
        if close is not None:
            if release_params is not None:
                release = release_params
            elif self.share_group is not None:
                release = self.share_group.release_one()
            else:
                release = self.owns_engine
            close(release_params=release)

    def health(self, max_age_s: float) -> Dict:
        doc = super().health(max_age_s)
        if self.plan_note:
            doc["plan"] = self.plan_note
        _slice_health(doc, self)
        return doc


def _slice_health(doc: Dict, replica) -> None:
    """A sliced replica's placement in its health doc: ``devices`` (its
    rank count, as the reference counts devices), ``ranks`` and
    ``placement`` ("shared" or "sliced")."""
    if replica.devices is not None:
        doc["devices"] = len(replica.devices)
        doc["ranks"] = list(replica.devices)
        doc["placement"] = replica.placement


def _pair_group(a: int, b: int):
    """A gloo group over ranks ``a`` and ``b`` (every rank calls this)."""
    import datetime

    import torch.distributed as dist

    extra = {} if pmesh._TIMEOUT[0] is None else dict(
        timeout=datetime.timedelta(seconds=pmesh._TIMEOUT[0]))
    return dist.new_group(ranks=sorted({a, b}), backend="gloo", **extra)


class _SliceLink:
    """The pool leader's line to a slice's first rank: one gloo pair group
    a direction, each read by one thread and written by one."""

    def __init__(self, leader: int, head: int):
        self.leader, self.head = leader, head
        self.down = _pair_group(leader, head)
        self.up = _pair_group(leader, head)
        self.idle_s = (pmesh._TIMEOUT[0] / 4.0 if pmesh._TIMEOUT[0]
                       else LINK_IDLE_S)

    @staticmethod
    def _send(msg, dst, group) -> None:
        import torch.distributed as dist

        dist.send_object_list([msg], dst=dst, group=group)

    @staticmethod
    def _recv(src, group):
        import torch.distributed as dist

        box = [None]
        dist.recv_object_list(box, src=src, group=group)
        return box[0]

    def send_down(self, msg) -> None:
        self._send(msg, self.head, self.down)

    def recv_down(self):
        return self._recv(self.leader, self.down)

    def send_up(self, msg) -> None:
        self._send(msg, self.leader, self.up)

    def recv_up(self):
        return self._recv(self.head, self.up)


def _portable(err: BaseException) -> BaseException:
    """``err`` if it pickles (it crosses ranks), else a ServeError with
    its type and message."""
    import pickle

    try:
        pickle.loads(pickle.dumps(err))
        return err
    except Exception:  # graftlint: disable=G05 any pickling failure means the error cannot travel as itself; its text still does
        return ServeError(f"{type(err).__name__}: {err}")


class SliceReplica(_BaseReplica):
    """The pool leader's handle of a replica whose slice it is not in: a
    dispatch sends the request to the slice's first rank, and a reader
    thread resolves the returned rows and errors onto the futures."""

    def __init__(self, rid: str, model: str, link: _SliceLink, devices,
                 placement: str, role: Optional[str] = None):
        super().__init__(rid, model, role=role)
        self.link = link
        self.devices = tuple(devices)
        self.placement = placement
        self._pending: Dict[int, ScoreFuture] = {}
        self._lock = threading.Lock()
        self._send_lock = threading.Lock()
        self._seq = itertools.count()
        self._last_sent = time.monotonic()
        self.error: Optional[BaseException] = None
        self._reader = threading.Thread(target=self._read, daemon=True,
                                        name=f"pool-slice-{rid}")
        self._reader.start()

    def _send(self, msg) -> None:
        with self._send_lock:
            self.link.send_down(msg)
            self._last_sent = time.monotonic()

    def tick(self) -> None:
        """An idle message when the line has been quiet a while, so that
        the slice's server does not time out waiting."""
        if (self.state == "live"
                and time.monotonic() - self._last_sent >= self.link.idle_s):
            self._send(("idle",))

    def dispatch(self, ticket: _PoolTicket) -> ScoreFuture:
        future = ScoreFuture()
        # the check and the registration are one step under the lock the
        # reader drains under: a request either sees the broken line and
        # bounces, or is registered before the drain fails it with the
        # line's error — never registered after the drain, never answered
        with self._lock:
            if self.state != "live" or self.error is not None:
                raise SchedulerClosed(f"replica {self.rid} is shut down")
            seq = next(self._seq)
            self._pending[seq] = future
        self._send(("request", seq, ticket.request))
        return future

    def _read(self) -> None:
        error = None
        try:
            while True:
                msg = self.link.recv_up()
                if msg[0] == "idle":
                    continue
                if msg[0] == "closed":
                    break
                _, seq, row, err, timing = msg
                with self._lock:
                    future = self._pending.pop(seq, None)
                if future is None:
                    continue
                future.timing = timing
                if err is not None:
                    future._set_exception(err)
                else:
                    future._set_result(row)
        # graftlint: disable=G05 a broken line fails every pending request with its error below; nothing above this thread could take it
        except Exception as err:
            error = err
        with self._lock:
            if error is not None:
                self.error = error
                self.state = "closed"      # the router selects it no more
            left, self._pending = list(self._pending.values()), {}
        for future in left:
            future._set_exception(error or SchedulerClosed(
                f"replica {self.rid} shut down before the request "
                f"completed"))

    def shutdown(self, drain: bool = True, **_kw) -> None:
        with self._lock:
            self.state = "closed"
            broken = self.error is not None
        if not broken:
            self._send(("close", drain))
        self._reader.join()

    def health(self, max_age_s: float) -> Dict:
        doc = super().health(max_age_s)
        _slice_health(doc, self)
        return doc


class _SliceServer:
    """On a slice's first rank (not the pool leader): requests from the
    leader go into the slice's scheduler, and their rows and errors go
    back as they resolve."""

    def __init__(self, replica: LocalReplica, link: _SliceLink):
        self.replica = replica
        self.link = link
        self._waiting: List = []
        self._lock = threading.Lock()
        self._closing = threading.Event()
        self.error: Optional[BaseException] = None
        self._threads = [
            threading.Thread(target=self._serve, daemon=True,
                             name=f"pool-serve-{replica.rid}"),
            threading.Thread(target=self._answer, daemon=True,
                             name=f"pool-answer-{replica.rid}")]
        for t in self._threads:
            t.start()

    def _serve(self) -> None:
        drain = True
        try:
            while True:
                msg = self.link.recv_down()
                if msg[0] == "idle":
                    continue
                if msg[0] == "close":
                    drain = msg[1]
                    break
                _, seq, request = msg
                try:
                    future = self.replica.scheduler.submit(request)
                except ServeError as err:
                    future = ScoreFuture()
                    future._set_exception(err)
                with self._lock:
                    self._waiting.append((seq, future))
        # graftlint: disable=G05 a broken line ends this server; join() raises it on the rank's own thread
        except Exception as err:
            self._fail(err)
        finally:
            self.replica.scheduler.close(drain=drain)
            self._closing.set()

    def _answer(self) -> None:
        last = time.monotonic()
        try:
            while True:
                with self._lock:
                    ready = [w for w in self._waiting if w[1].done()]
                    for w in ready:
                        self._waiting.remove(w)
                    idle = not self._waiting
                for seq, future in ready:
                    err = future.exception(timeout=0)
                    self.link.send_up((
                        "row", seq,
                        None if err is not None else future.result(0),
                        None if err is None else _portable(err),
                        future.timing))
                    last = time.monotonic()
                if ready:
                    continue
                if self._closing.is_set() and idle:
                    self.link.send_up(("closed",))
                    return
                if time.monotonic() - last >= self.link.idle_s:
                    self.link.send_up(("idle",))
                    last = time.monotonic()
                time.sleep(DISPATCH_TICK_S)
        # graftlint: disable=G05 a broken line ends this server; join() raises it on the rank's own thread
        except Exception as err:
            self._fail(err)

    def _fail(self, err: BaseException) -> None:
        """Keep the first error either thread met: the one that broke the
        line, not a later one it caused."""
        with self._lock:
            if self.error is None:
                self.error = err

    def join(self) -> None:
        for t in self._threads:
            t.join()
        if self.error is not None:
            raise self.error


class RemoteBackend:
    """An ``api_backends/`` vendor client as a pool replica's engine.

    ``evaluate(prompt, targets, with_confidence, max_new_tokens)``
    returns a vendor-shaped dict (the :mod:`..api_backends.evaluators`
    contract: ``yes_prob``/``no_prob``/``relative_prob``/``response``,
    optionally ``confidence``/``weighted_confidence``/``raw``); the
    backend normalizes it to the engine result-row schema so the pool's
    callers never see which backend answered.  The construction helpers
    (:meth:`openai`, :meth:`gemini`, :meth:`anthropic`) wrap the port's
    API clients in the evaluators of :mod:`..api_backends.evaluators`.

    Cost: per-request USD estimated from :class:`CostTracker` pricing
    (chars/4 prompt-token heuristic; actual usage is recorded into the
    tracker when the vendor response carries a ``usage`` block), which
    the router's cost term reads BEFORE dispatch."""

    #: prompt-chars-per-token estimation heuristic for pre-dispatch cost.
    CHARS_PER_TOKEN = 4.0
    #: assumed completion tokens when the request caps nothing (the
    #: binary contract answers in a handful of tokens).
    DEFAULT_OUTPUT_TOKENS = 16

    def __init__(self, model: str, evaluate: Callable[..., Dict],
                 pricing: Optional[Dict] = None, cost_tracker=None):
        from ..api_backends.cost import CostTracker

        self.model = model
        self.evaluate = evaluate
        self.tracker = cost_tracker or CostTracker(pricing=pricing)
        if pricing is not None:
            self.tracker.pricing = dict(self.tracker.pricing or {})
            self.tracker.pricing.update(pricing)

    # -- vendor constructors --------------------------------------------

    @classmethod
    def openai(cls, client, model: str, **kw) -> "RemoteBackend":
        from ..api_backends import evaluators

        def evaluate(prompt, targets, with_confidence, max_new_tokens):
            if with_confidence:
                return evaluators.evaluate_gpt_confidence(
                    client, model, prompt)
            return evaluators.evaluate_gpt_binary(
                client, model, prompt, targets=tuple(targets))

        return cls(model, evaluate, **kw)

    @classmethod
    def gemini(cls, client, model: str, **kw) -> "RemoteBackend":
        from ..api_backends import evaluators

        def evaluate(prompt, targets, with_confidence, max_new_tokens):
            if with_confidence:
                return evaluators.evaluate_gemini_confidence(
                    client, model, prompt)
            return evaluators.evaluate_gemini_binary(
                client, model, prompt, targets=tuple(targets))

        return cls(model, evaluate, **kw)

    @classmethod
    def anthropic(cls, client, model: str, **kw) -> "RemoteBackend":
        from ..api_backends import evaluators

        def evaluate(prompt, targets, with_confidence, max_new_tokens):
            return evaluators.evaluate_claude(client, model, prompt)

        return cls(model, evaluate, **kw)

    # -- contract -------------------------------------------------------

    def cost_estimate_usd(self, request: ScoreRequest) -> float:
        p = self.tracker.pricing.get(self.model)
        if not p:
            return 0.0
        prompt = request.prompt if isinstance(request.prompt, str) else ""
        in_tok = len(prompt) / self.CHARS_PER_TOKEN
        out_tok = request.max_new_tokens or self.DEFAULT_OUTPUT_TOKENS
        return (in_tok / 1e6 * p.get("input", 0.0)
                + out_tok / 1e6 * p.get("output", 0.0))

    def score_one(self, request: ScoreRequest) -> Dict:
        if request.prompt is None:
            raise ValueError(
                "remote backends score plain prompts; the prefix/suffix "
                "fused spelling is a local-engine capability")
        vendor = self.evaluate(request.prompt, request.targets,
                               request.with_confidence,
                               request.max_new_tokens)
        raw = vendor.get("raw")
        if isinstance(raw, dict) and raw.get("usage"):
            self.tracker.record_response(self.model, raw)
        else:
            prompt = request.prompt if isinstance(request.prompt, str) else ""
            self.tracker.record(
                self.model, int(len(prompt) / self.CHARS_PER_TOKEN),
                self.DEFAULT_OUTPUT_TOKENS)
        return self._result_row(vendor)

    @staticmethod
    def _result_row(vendor: Dict) -> Dict:
        """Vendor dict -> the engine's result-row schema
        (runtime/engine._result_row contract).  Fields a vendor cannot
        provide (odds_ratio without both probs, scan_found) derive or
        default honestly rather than pretending."""
        yes = float(vendor.get("yes_prob", float("nan")))
        no = float(vendor.get("no_prob", float("nan")))
        rel = vendor.get("relative_prob")
        if rel is None and yes == yes and no == no and (yes + no) > 0:
            rel = yes / (yes + no)
        row = {
            "yes_prob": yes,
            "no_prob": no,
            "relative_prob": (float(rel) if rel is not None
                              else float("nan")),
            "odds_ratio": (yes / no if no and no == no and yes == yes
                           else float("nan")),
            "scan_found": bool(vendor.get("yes_prob") is not None
                               or vendor.get("no_prob") is not None),
            "completion": str(vendor.get("response", "")),
            "success": True,
        }
        for key in ("confidence", "weighted_confidence"):
            if key in vendor:
                row[key] = vendor[key]
        return row


class RemoteReplica(_BaseReplica):
    """A :class:`RemoteBackend` behind the same router as local
    replicas: one daemon worker drains this replica's FIFO (vendor
    clients are blocking HTTP), latency lands in the same EWMA the
    router scores, and spend accumulates in the backend's tracker."""

    kind = "remote"

    def __init__(self, rid: str, backend: RemoteBackend,
                 model: Optional[str] = None):
        super().__init__(rid, model or backend.model)
        self.backend = backend
        self._work: "queue_mod.SimpleQueue[Optional[_PoolTicket]]" = (
            queue_mod.SimpleQueue())
        self._thread = threading.Thread(
            target=self._worker, name=f"pool-remote-{rid}", daemon=True)
        self._thread.start()

    def cost_estimate_usd(self, request: ScoreRequest) -> float:
        return self.backend.cost_estimate_usd(request)

    def dispatch(self, ticket: _PoolTicket) -> ScoreFuture:
        future = ScoreFuture()
        ticket.replica_future = future
        self._work.put(ticket)
        return future

    def queue_depth(self) -> int:
        return self._work.qsize()

    def _worker(self) -> None:
        while True:
            ticket = self._work.get()
            if ticket is None:
                return
            t0 = time.monotonic()
            if ticket.expired(t0):
                # the deadline contract holds on the remote leg too: an
                # expired request must not spend real vendor dollars and
                # resolve late — it rejects typed, like the local
                # scheduler's queue sweep
                ticket.replica_future._set_exception(DeadlineExceeded(
                    f"deadline passed {t0 - ticket.deadline:.3f}s before "
                    f"the remote backend call"))
                continue
            try:
                row = self.backend.score_one(ticket.request)
            except Exception as err:  # graftlint: disable=G05 vendor relay: transport/HTTP errors become this request's typed failure on its future; the worker must keep draining the replica queue
                ticket.replica_future._set_exception(err)
                continue
            ticket.replica_future.timing = {
                "e2e_ms": (time.monotonic() - t0) * 1000.0}
            ticket.replica_future._set_result(row)

    def shutdown(self, drain: bool = True, **_kw) -> None:
        self.state = "closed"
        self._work.put(None)
        self._thread.join(timeout=5.0 if drain else 0.5)


class EnginePool:
    """Multi-replica serving front door (module docstring).

    Usage::

        pool = EnginePool(config=PoolConfig())
        pool.load("falcon-7b", engine_a)           # replica r0
        pool.load("falcon-7b", engine_b)           # replica r1 (same model)
        pool.load_remote(RemoteBackend.openai(client, "gpt-4o-mini"))
        fut = pool.submit(ScoreRequest(prompt=...), model="falcon-7b")
        row = fut.result(timeout=60)
        pool.unload("r0")                          # hot: r1 keeps serving
        pool.close()
    """

    def __init__(self, config: Optional[PoolConfig] = None):
        self.config = config or PoolConfig()
        self._sched_template = self.config.scheduler or SchedulerConfig()
        self._replicas: Dict[str, Any] = {}
        self._queues: Dict[str, collections.deque] = {}
        self._inflight: List[_PoolTicket] = []
        self._known_models: set = set()
        self._capacity = max(1, self._sched_template.queue_capacity)
        self._seq = 0
        self._rid_counter = itertools.count()
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        #: world rank 0 takes the requests and routes them (one process
        #: a rank; every rank builds the pool and loads every replica)
        self.leads = _world()[0] == 0
        self.supervisor: Optional[ReplicaSupervisor] = None
        if self.config.supervision is not None:
            self.supervisor = ReplicaSupervisor(
                self, self.config.supervision)
        self._router = threading.Thread(
            target=self._route_loop, name="pool-router", daemon=True)
        self._router.start()

    def supervise(self, config: Optional[SupervisorConfig] = None
                  ) -> ReplicaSupervisor:
        """Arm fleet self-healing on a running pool (idempotent): every
        current and future replica gains crash/wedge supervision, and
        the returned :class:`ReplicaSupervisor` takes rebuild-factory
        registrations (:meth:`ReplicaSupervisor.register_rebuild`)."""
        with self._wake:
            if self.supervisor is None:
                self.supervisor = ReplicaSupervisor(
                    self, config or self.config.supervision)
                for replica in self._replicas.values():
                    self.supervisor.track(replica)
        return self.supervisor

    # -- replica lifecycle ----------------------------------------------

    def load(self, model: str, engine, replica_id: Optional[str] = None,
             owns_engine: bool = True,
             plan_note: Optional[str] = None,
             share_group: Optional[ParamShareGroup] = None,
             plan=None, role: Optional[str] = None,
             devices=None) -> LocalReplica:
        """Hot-add a local replica — traffic already queued for
        ``model`` starts draining onto it on the next router tick; no
        other replica pauses.  ``share_group`` refcounts a param tree
        shared with sibling replicas (the last sibling to unload
        releases the buffers, whatever the order).  ``plan`` (an
        operating point with ``batch``, ``kv_dtype``, ``prefill_chunk``,
        ``pool_target`` and ``reason``) applies to THIS replica's engine
        config (:func:`replica_engine_config`) and doubles as its
        health-doc plan note.

        ``role`` splits the fleet into prefill/decode specialists
        (``None`` = general): a ``"prefill"`` replica's scheduler gets a
        handoff hook that ships finished int8/bf16 KV slabs to the
        least-loaded live ``"decode"`` sibling of the same model, whose
        slot ring imports them mid-flight; when no decode sibling is
        live the prefill replica decodes locally (always-answered beats
        role purity).  ``devices`` (ranks: a slice of
        :func:`~..parallel.mesh.carve_slices`) binds the replica to
        ``make_mesh(data=len(devices), devices=devices)``; on a world of
        ranks every rank makes this call for every replica, in the same
        order, with the engine of each replica it hosts (None for one it
        does not)."""
        if role not in (None, "prefill", "decode"):
            raise ValueError(
                f"role must be None, 'prefill', or 'decode': {role!r}")
        if plan is not None and engine is not None:
            engine.ecfg = replica_engine_config(engine.ecfg, plan)
            plan_note = plan_note or plan.reason
        with self._wake:
            if self._closed:
                raise PoolClosed("pool is shut down")
            rid = replica_id or f"r{next(self._rid_counter)}"
            if rid in self._replicas:
                raise ValueError(f"replica id {rid!r} already loaded")
            replica = LocalReplica(rid, model, engine,
                                   self._sched_template,
                                   owns_engine=owns_engine,
                                   plan_note=plan_note,
                                   share_group=share_group,
                                   role=role, devices=devices)
            rank, world = _world()
            link = None
            if replica.devices is not None and world > 1 \
                    and replica.devices[0] != 0:
                link = _SliceLink(0, replica.devices[0])
            if link is not None and self.leads:
                replica = SliceReplica(rid, model, link, replica.devices,
                                       replica.placement, role=role)
            elif link is not None and rank == replica.devices[0]:
                replica.server = _SliceServer(replica, link)
            if not (self.leads or replica.hosted):
                # a replica of another slice: nothing of it on this rank
                record_counter("pool_replicas_loaded")
                return replica
            if role == "prefill" and isinstance(replica, LocalReplica):
                replica.scheduler.handoff = self._make_handoff(replica)
            self._replicas[rid] = replica
            self._known_models.add(model)
            self._queues.setdefault(model, collections.deque())
            if self.supervisor is not None:
                self.supervisor.track(replica)
            record_counter("pool_replicas_loaded")
            self._wake.notify_all()
        return replica

    def load_remote(self, backend: RemoteBackend,
                    model: Optional[str] = None,
                    replica_id: Optional[str] = None) -> RemoteReplica:
        """Hot-add an ``api_backends/`` vendor as a replica of ``model``
        (default: the backend's own model name) — it enters the same
        least-loaded/cost-aware selection as every local replica."""
        with self._wake:
            if self._closed:
                raise PoolClosed("pool is shut down")
            rid = replica_id or f"r{next(self._rid_counter)}"
            if rid in self._replicas:
                raise ValueError(f"replica id {rid!r} already loaded")
            replica = RemoteReplica(rid, backend, model=model)
            self._replicas[rid] = replica
            self._known_models.add(replica.model)
            self._queues.setdefault(replica.model, collections.deque())
            if self.supervisor is not None:
                self.supervisor.track(replica)
            record_counter("pool_replicas_loaded")
            self._wake.notify_all()
        return replica

    def unload(self, replica_id: str, drain: bool = True,
               release_params: Optional[bool] = None) -> None:
        """Hot-remove one replica WITHOUT draining the rest of the pool:
        the router stops selecting it immediately, its queued work
        finishes (``drain=True``), any request it bounces re-enters the
        model queue (always-answered), and the engine tears down through
        :meth:`ScoringEngine.close` — buffer census back to baseline, so
        a different model can load into the freed HBM in-process."""
        with self._wake:
            replica = self._replicas.get(replica_id)
            if replica is None:
                raise ValueError(f"unknown replica {replica_id!r}")
            if replica.state == "closed":
                return
            replica.state = "draining"
        # outside the lock: draining blocks on engine work, and the
        # router must keep serving the other replicas meanwhile
        replica.shutdown(drain=drain, release_params=release_params)
        with self._wake:
            self._replicas.pop(replica_id, None)
            if self.supervisor is not None:
                self.supervisor.untrack(replica_id)
            record_counter("pool_replicas_unloaded")
            self._wake.notify_all()

    def replicas(self, model: Optional[str] = None) -> List:
        with self._lock:
            return [r for r in self._replicas.values()
                    if model is None or r.model == model]

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._known_models)

    # -- submission ------------------------------------------------------

    def submit(self, request: ScoreRequest,
               model: Optional[str] = None) -> ScoreFuture:
        """Admit one request for ``model`` (optional when the request
        names one, or when the pool serves exactly one model).  Returns
        a future resolving to the replica's ordinary result row; typed
        errors follow the scheduler conventions: the per-model front
        queue is BOUNDED (the scheduler template's ``queue_capacity``
        — past it, typed :class:`QueueFull` backpressure), a deadline
        covers the POOL queue time too (expired tickets reject with
        :class:`DeadlineExceeded`, and the replica leg gets only the
        remaining budget), and higher ``priority`` dispatches first."""
        request.validate()
        if not self.leads:
            raise ServeError("a pool on a world of ranks takes requests on "
                             "rank 0 only")
        model = model or getattr(request, "model", None)
        now = time.monotonic()
        with self._wake:
            if self._closed:
                record_counter("serve_rejected_closed")
                raise PoolClosed("pool is shut down")
            if model is None:
                if len(self._known_models) != 1:
                    raise ValueError(
                        f"pool serves {sorted(self._known_models)}; "
                        f"submit(model=...) must name one")
                model = next(iter(self._known_models))
            if model not in self._known_models:
                raise UnknownModel(
                    f"no replica serves {model!r} (loaded: "
                    f"{sorted(self._known_models)})")
            if len(self._queues[model]) >= self._capacity:
                record_counter("serve_rejected_full")
                raise QueueFull(
                    f"pool queue for {model!r} at capacity "
                    f"({self._capacity})")
            timeout_s = (request.timeout_s
                         if request.timeout_s is not None
                         else self._sched_template.default_timeout_s)
            self._seq += 1
            ticket = _PoolTicket(
                request=request, future=ScoreFuture(), model=model,
                enqueue_t=now, seq=self._seq,
                deadline=None if timeout_s is None else now + timeout_s)
            self._queues[model].append(ticket)
            record_counter("pool_enqueued")
            self._wake.notify_all()
        return ticket.future

    def submit_many(self, requests, model: Optional[str] = None
                    ) -> List[ScoreFuture]:
        return [self.submit(r, model=model) for r in requests]

    # -- router ----------------------------------------------------------

    def _select_replica(self, model: str, request: ScoreRequest):
        """Least-loaded compatible replica: smallest routing score =
        latency_weight x predicted wait (observed-latency EWMA x (1 +
        outstanding + queued)) + cost_weight x estimated USD x the
        configured exchange rate.  Local replicas cost $0, so the cost
        term is pure vendor-spill pressure.

        Role affinity rides on top: fresh prompts prefer prefill/general
        replicas — a ``"decode"`` specialist's chips are reserved for
        handed-off slabs and selected only when no other sibling is live
        (always-answered fallback, counted as ``pool_decode_fallback``)."""
        cfg = self.config
        best, best_score = None, None
        decode_best, decode_best_score = None, None
        for replica in self._replicas.values():
            if replica.model != model or replica.state != "live":
                continue
            if (self.supervisor is not None
                    and not self.supervisor.allows(replica)):
                continue        # vendor breaker open: shed to siblings
            score = (cfg.latency_weight * replica.predicted_wait_s()
                     + cfg.cost_weight * replica.cost_estimate_usd(request)
                     * cfg.cost_scale_s_per_usd)
            if getattr(replica, "role", None) == "decode":
                if decode_best_score is None or score < decode_best_score:
                    decode_best, decode_best_score = replica, score
                continue
            if best_score is None or score < best_score:
                best, best_score = replica, score
        if best is None and decode_best is not None:
            record_counter("pool_decode_fallback")
            return decode_best
        return best

    def _make_handoff(self, source: LocalReplica):
        """Build the prefill→decode slab-shipping hook installed on a
        ``"prefill"`` replica's scheduler (``scheduler.handoff``).

        Called on the PREFILL replica's scheduler loop thread with
        ``(slab, tickets, launch_t)``; picks the least-loaded live
        ``"decode"`` sibling of the same model under the pool lock, then
        submits OUTSIDE it (``submit_slab`` only touches the target's
        own locks, so no lock cycle with the router).  Returns False —
        prefill decodes locally — when no decode sibling accepts; a
        ``SchedulerClosed`` bounce tries the next candidate, mirroring
        the router's always-answered re-dispatch."""

        def handoff(slab, tickets, launch_t) -> bool:
            with self._lock:
                cands = sorted(
                    (r for r in self._replicas.values()
                     if r is not source and r.model == source.model
                     and r.state == "live"
                     and getattr(r, "role", None) == "decode"
                     and isinstance(r, LocalReplica)),
                    key=lambda r: r.predicted_wait_s())
            for target in cands:
                try:
                    target.scheduler.submit_slab(slab, tickets, launch_t)
                except SchedulerClosed:
                    continue
                record_counter("pool_slab_handoffs")
                return True
            return False

        return handoff

    def _route_loop(self) -> None:
        while True:
            with self._wake:
                if (self._closed and not self._inflight
                        and not any(self._queues.values())):
                    return
                dispatched = self._dispatch_ready()
                resolved = self._reap_inflight()
                for replica in self._replicas.values():
                    if isinstance(replica, SliceReplica):
                        replica.tick()
                if not dispatched and not resolved:
                    # replica futures resolve on replica threads that
                    # cannot signal this condition, so IN-FLIGHT work
                    # polls at the fine tick; an idle pool blocks at the
                    # coarse one (submit/load/unload/close all notify)
                    self._wake.wait(timeout=(
                        DISPATCH_TICK_S if self._inflight
                        else IDLE_TICK_S))

    def _expire_queued(self, q, now: float) -> None:
        """Deadline sweep of one model queue (lock held): the pool front
        queue honors request deadlines exactly like the scheduler's
        admission queue — expired tickets reject TYPED, and a queue
        orphaned by an unload cannot silently hold bounded-time
        requests forever."""
        expired = [t for t in q if t.expired(now)]
        for ticket in expired:
            q.remove(ticket)
            record_counter("serve_rejected_deadline")
            ticket.future._set_exception(DeadlineExceeded(
                f"deadline passed after "
                f"{now - ticket.enqueue_t:.3f}s in the pool queue"))

    def _dispatch_ready(self) -> int:
        """Move queued tickets onto replicas (callers hold the lock):
        highest priority first (FIFO within a level), each carrying only
        its REMAINING deadline budget into the replica leg."""
        n = 0
        now = time.monotonic()
        for model, q in self._queues.items():
            self._expire_queued(q, now)
            while q:
                ticket = min(q, key=_PoolTicket.sort_key)
                replica = self._select_replica(model, ticket.request)
                if replica is None:
                    break               # no live replica: wait (hot swap)
                if ticket.deadline is not None:
                    # the replica's scheduler re-anchors timeout_s at ITS
                    # submit time; hand it the remaining budget so the
                    # pool wait is not silently granted twice.  The
                    # ticket keeps the adjusted copy (recomputed from the
                    # absolute deadline on every re-dispatch).
                    ticket.request = dataclasses.replace(
                        ticket.request,
                        timeout_s=max(0.0,
                                      ticket.deadline - time.monotonic()))
                try:
                    rf = replica.dispatch(ticket)
                except ServeError:
                    # replica-level backpressure/shutdown race: back on
                    # the model queue, try again next tick (possibly on
                    # another replica) — never dropped
                    break
                q.remove(ticket)
                ticket.replica_future = rf
                ticket.replica = replica
                ticket.dispatch_t = time.monotonic()
                replica.outstanding += 1
                if self.supervisor is not None:
                    self.supervisor.on_dispatch(replica)
                self._inflight.append(ticket)
                n += 1
        return n

    def _reap_inflight(self) -> int:
        """Relay resolved replica futures onto pool futures (lock held).
        A ``SchedulerClosed`` bounce from a replica that shut down under
        the request re-queues the ticket — the unload path's
        always-answered guarantee.  Under supervision
        (serve/supervisor.py) this is also where failover happens:
        crashed legs re-queue, legs stranded on a torn-down quarantined
        replica are reclaimed, and hedge legs race first-wins."""
        n = 0
        still: List[_PoolTicket] = []
        for ticket in self._inflight:
            if self._reap_one(ticket):
                n += 1
            else:
                still.append(ticket)
        self._inflight = still
        return n

    def _reap_one(self, ticket: _PoolTicket) -> bool:
        """True when the ticket left the in-flight set (resolved,
        requeued, or typed-rejected); False = still waiting."""
        sup = self.supervisor
        # hedge leg first: a successful hedge answers the request
        # (first-wins on the pool future); a failed one drops silently —
        # the primary leg is still racing
        hf = ticket.hedge_future
        if hf is not None and hf.done():
            hedge_replica = ticket.hedge_replica
            hedge_replica.outstanding = max(
                0, hedge_replica.outstanding - 1)
            herr = hf.exception(timeout=0)
            ticket.hedge_future = None
            ticket.hedge_replica = None
            if herr is None:
                if sup is not None:
                    if ticket.replica is not None:
                        # the slow primary leg is orphaned: its replica's
                        # outstanding drops when it eventually resolves
                        sup.orphan_leg(ticket.replica,
                                       ticket.replica_future)
                        ticket.replica = None
                        ticket.replica_future = None
                    sup.note_hedge_won(ticket)
                self._resolve_success(ticket, hf, hedge_replica,
                                      hedged=True)
                return True
            if (sup is not None
                    and not isinstance(herr, SchedulerClosed)):
                sup.handle_hedge_failure(hedge_replica, herr)
        rf = ticket.replica_future
        replica = ticket.replica
        if rf is None or not rf.done():
            # supervised: a leg still unresolved AFTER a quarantined
            # replica's teardown completed (state reached "closed" and
            # the scheduler bounce already re-queued everything it
            # could) is the wedged batch itself — fail it over instead
            # of waiting on a corpse
            if (sup is not None and replica is not None
                    and getattr(replica, "quarantined", False)
                    and replica.state == "closed"):
                replica.outstanding = max(0, replica.outstanding - 1)
                if ticket.hedge_future is not None:
                    # promote the live hedge leg to primary
                    ticket.replica_future = ticket.hedge_future
                    ticket.replica = ticket.hedge_replica
                    ticket.hedge_future = None
                    ticket.hedge_replica = None
                    return False
                sup.reclaim_locked(ticket)
                return True
            return False
        replica.outstanding = max(0, replica.outstanding - 1)
        err = rf.exception(timeout=0)
        if isinstance(err, SchedulerClosed):
            record_counter("pool_redispatched")
            ticket.replica_future = None
            ticket.replica = None
            self._queues[ticket.model].appendleft(ticket)
            return True
        if err is not None:
            if sup is not None and sup.handle_failure(ticket, replica,
                                                      err):
                return True
            replica.failed += 1
            record_counter("pool_failed")
            ticket.future._set_exception(err)
            return True
        self._resolve_success(ticket, rf, replica, hedged=False)
        return True

    def _resolve_success(self, ticket: _PoolTicket, rf: ScoreFuture,
                         replica, hedged: bool) -> None:
        replica.completed += 1
        timing = rf.timing
        e2e_s = None
        if timing and "e2e_ms" in timing:
            e2e_s = timing["e2e_ms"] / 1000.0
        elif ticket.dispatch_t is not None:
            e2e_s = time.monotonic() - ticket.dispatch_t
        if e2e_s is not None:
            replica.note_latency(e2e_s)
        if self.supervisor is not None:
            self.supervisor.on_success(replica, e2e_s)
            if ticket.failovers or hedged:
                # failover/hedge provenance rides the TIMING (future-
                # side), never the row: replay bit-parity (PARITY.md)
                timing = dict(timing or {})
                timing["failovers"] = ticket.failovers
                if hedged:
                    timing["hedged"] = True
        ticket.future.timing = timing
        record_counter("pool_completed")
        ticket.future._set_result(rf.result(timeout=0))

    # -- lifecycle / health ---------------------------------------------

    def queue_depth(self) -> int:
        """Pool-level queued + every replica's local queue — the front
        door's total backlog (the load harness's depth trajectory)."""
        with self._lock:
            return (sum(len(q) for q in self._queues.values())
                    + sum(r.queue_depth() for r in self._replicas.values()))

    def health(self) -> Dict:
        """The /healthz contribution: per-replica health (id, model,
        queue depth, oldest-wait age) so ONE wedged replica reads
        degraded while the pool stays up; a model with queued traffic
        and no live replica degrades too (mid-swap visibility)."""
        max_age = (self.config.health_max_queue_age_s
                   or getattr(self._sched_template,
                              "health_max_queue_age_s", 0))
        with self._lock:
            replicas = [r.health(max_age) for r in self._replicas.values()]
            queued = {m: len(q) for m, q in self._queues.items() if q}
            orphaned = sorted(
                m for m, q in self._queues.items()
                if q and not any(r.model == m and r.state == "live"
                                 for r in self._replicas.values()))
        doc = {
            "pool": "closed" if self._closed else "running",
            "replicas": replicas,
            "queued_by_model": queued,
        }
        if self.supervisor is not None:
            breakers = self.supervisor.breaker_states()
            if breakers:
                doc["breakers"] = breakers
        degraded = [r["replica"] for r in replicas
                    if r.get("status") == "degraded"]
        if orphaned:
            doc["status"] = "degraded"
            doc["degraded_reason"] = (
                f"model(s) {orphaned} have queued traffic and no live "
                f"replica")
        elif degraded:
            doc["status"] = "degraded"
            doc["degraded_reason"] = (
                f"replica(s) {degraded} exceed the queue-age threshold")
        return doc

    def client(self, model: Optional[str] = None) -> "PoolClient":
        """A Scheduler-shaped facade over this pool (submit/queue/close
        with close a no-op) — what lets ``serve/load.py`` drive the pool
        through the SAME open-loop harness as a single engine."""
        return PoolClient(self, model=model)

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Shut the whole pool down: stop admitting, let the router
        drain queued + in-flight work (bounded by ``drain_timeout_s``),
        close every replica (verified engine teardown), and fail
        anything left with the typed :class:`PoolClosed`."""
        with self._wake:
            if self._closed:
                return
            self._closed = True
            self._wake.notify_all()
        deadline = time.monotonic() + (
            timeout if timeout is not None
            else (self.config.drain_timeout_s if drain else 0.5))
        while drain and time.monotonic() < deadline:
            with self._lock:
                idle = not self._inflight and not any(
                    self._queues.values())
            if idle:
                break
            time.sleep(DISPATCH_TICK_S)
        if self.supervisor is not None:
            self.supervisor.stop()
        for replica in list(self._replicas.values()):
            replica.shutdown(drain=drain)
        with self._wake:
            self._replicas.clear()
            leftovers = [t for q in self._queues.values() for t in q]
            leftovers += [t for t in self._inflight
                          if not t.future.done()]
            for q in self._queues.values():
                q.clear()
            self._inflight = []
            self._wake.notify_all()
        for ticket in leftovers:
            if not ticket.future.done():
                record_counter("serve_rejected_closed")
                ticket.future._set_exception(PoolClosed(
                    "pool shut down before the request completed"))
        self._router.join(timeout=2.0)

    def __enter__(self) -> "EnginePool":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)


class PoolClient:
    """Duck-typed :class:`Scheduler` facade for one model of a pool.

    ``serve/load.run_load`` drives whatever ``scheduler_factory`` hands
    it through submit/queue/close; this facade forwards submits to the
    pool (pinning ``model``), exposes the pool-wide backlog as
    ``len(client.queue)``, and makes ``close()`` a no-op — ONE pool
    serves every rate point of a sweep, its lifetime owned by the
    caller, not by one load run."""

    class _QueueView:
        def __init__(self, pool: EnginePool):
            self._pool = pool

        def __len__(self) -> int:
            return self._pool.queue_depth()

    def __init__(self, pool: EnginePool, model: Optional[str] = None):
        self.pool = pool
        self.model = model
        self.queue = self._QueueView(pool)

    def submit(self, request: ScoreRequest) -> ScoreFuture:
        return self.pool.submit(request, model=self.model)

    def close(self, drain: bool = True) -> None:
        pass  # the pool outlives one load run


def replica_engine_config(base, plan) -> Any:
    """Apply a chosen operating point to a replica's
    :class:`~..runtime.engine.EngineConfig`: batch / kv-dtype / chunk /
    pool-target come from ``plan`` instead of the fleet-wide flags."""
    if plan is None:
        return base
    return dataclasses.replace(
        base, batch_size=plan.batch, kv_dtype=plan.kv_dtype,
        prefill_chunk=plan.prefill_chunk,
        phase2_pool_target=plan.pool_target)
