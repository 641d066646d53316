"""Fleet self-healing for :class:`~.pool.EnginePool` (the JAX package's
``serve/supervisor.py``).

The pool *reports* a sick replica — health() reads degraded — but never
heals it, and a replica failure would strand its in-flight requests,
violating the serve layer's always-answered contract.  The fault layer
(:mod:`..runtime.faults`) classifies and retries at the ENGINE level;
this module lifts that discipline to the FLEET level:

- **Failure detection & classification.**  Per-replica watchdog beats
  (reusing :class:`~..obs.flight.StallWatchdog`: beat on dispatch and
  on completion, checked only while the replica has work) distinguish
  a *crash* (an engine call raised a non-request error), a *wedge* (no
  forward progress past the wedge timeout while busy), and a
  *poison row* (the same request kills ``poison_kill_limit`` replicas
  → typed :class:`~.request.PoisonousRequest`, never a third kill).
- **Quarantine + rebuild.**  A failed replica leaves the router
  immediately (state ``quarantined`` — :meth:`EnginePool._select_replica`
  only picks ``live``), is torn down through the verified
  :meth:`~..runtime.engine.ScoringEngine.close` census, and is rebuilt
  from a registered per-model engine factory (the shared-snapshot
  sibling path makes rebuilds free of weight HBM) after a FULL-jitter
  exponential backoff (:func:`~..runtime.faults.fleet_backoff_delay`),
  with a ``max_rebuilds`` ceiling: a flapping replica is permanently
  quarantined instead of churning the pool forever.
- **In-flight failover.**  Requests stranded on a failed replica
  re-enter the per-model queue and re-route to a sibling.  At-most-once
  answer semantics ride the :class:`~.request.ScoreFuture` first-wins
  resolve guard; the failover count is stamped on the future's
  ``timing`` — never the result row, so replay bit-parity holds
  (PARITY.md: supervision changes WHERE/WHEN a row computes, never
  WHAT).  Opt-in tail-latency hedging launches a second leg on a
  sibling once a request has been in flight longer than ``hedge_k`` x
  the model's observed p99 — scoring requests are idempotent and
  deterministic, so the losing leg is simply dropped.
- **Vendor circuit breakers.**  Remote (:class:`~.pool.RemoteBackend`)
  replicas gain a closed/open/half-open :class:`CircuitBreaker` over
  the existing cost/latency router: a down vendor stops being selected
  (sheds to local replicas) instead of burning retry budget, and
  half-open probes re-admit it after the cooldown.

Locking: the supervisor's mutable state is guarded by the POOL's lock
— router hooks (`handle_failure`, `reclaim_locked`, `on_dispatch`,
`on_success`) run with it held, and the monitor thread / rebuild
workers acquire ``pool._wake`` before touching shared state.  The
:class:`CircuitBreaker` carries its own small lock so `allow()` is
safe from any thread.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

from ..obs.flight import StallWatchdog
from ..runtime.faults import fleet_backoff_delay, fleet_backoff_policy
from ..utils.telemetry import record_counter, record_fault
from .request import PoisonousRequest, ScoreFuture, ServeError
from .scheduler import labeled_metric


def _labeled_counter(name: str, labels: Dict) -> None:
    """Base counter + its ``name|replica=…`` labeled twin (the
    scheduler's labeled-metric convention, so per-replica series export
    next to the fleet aggregate)."""
    record_counter(name)
    record_counter(name + labeled_metric("", labels))


@dataclasses.dataclass
class SupervisorConfig:
    """Self-healing knobs.  Defaults are conservative: wedge detection
    arms only when a wedge timeout is configured (here or via the
    pool's ``health_max_queue_age_s``), and hedging is opt-in."""

    #: a busy replica with no dispatch/completion beat for this long is
    #: wedged (0 falls back to the pool's ``health_max_queue_age_s``;
    #: both 0 disables wedge detection).
    wedge_timeout_s: float = 0.0
    #: the same request crashing/wedging this many replicas is poisoned:
    #: typed :class:`PoisonousRequest`, never another kill.
    poison_kill_limit: int = 2
    #: per-request ceiling on vendor-failure failovers (a persistently
    #: failing vendor row propagates its real error past this).
    max_failovers: int = 3
    #: rebuilds per replica lineage before permanent quarantine.
    max_rebuilds: int = 3
    #: full-jitter rebuild backoff window (runtime/faults.py
    #: fleet_backoff_policy — decorrelates N rebuilds/failovers that
    #: started their clocks at the same crash).
    rebuild_backoff_initial_s: float = 0.5
    rebuild_backoff_max_s: float = 30.0
    #: opt-in tail-latency hedging: a second leg launches on a sibling
    #: once a request has been in flight > hedge_k x observed p99 for
    #: its model (needs hedge_min_samples completions first).
    hedge: bool = False
    hedge_k: float = 3.0
    hedge_min_samples: int = 32
    #: vendor breaker: consecutive failures to open, cooldown before a
    #: half-open probe, probes that must succeed to re-close.
    breaker_failure_threshold: int = 5
    breaker_cooldown_s: float = 30.0
    breaker_halfopen_probes: int = 1
    #: monitor-thread tick (wedge checks, due rebuilds, hedge scans).
    poll_s: float = 0.05


class CircuitBreaker:
    """Closed/open/half-open breaker over one remote replica.

    closed --(threshold consecutive failures)--> open
    open --(cooldown elapsed)--> half-open (admits ``probes`` requests)
    half-open --(probe success x probes)--> closed
    half-open --(probe failure)--> open (cooldown restarts)

    State transitions record a ``breaker_state`` counter labeled with
    the replica and the NEW state; opening records a ``breaker_open``
    fault event (a flight-recorder trigger)."""

    def __init__(self, rid: str, model: str, threshold: int = 5,
                 cooldown_s: float = 30.0, probes: int = 1,
                 clock=time.monotonic):
        self.rid = rid
        self.model = model
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.probes = max(1, int(probes))
        self._clock = clock
        self._lock = threading.Lock()
        self.state = "closed"
        self._failures = 0            # consecutive
        self._opened_t: Optional[float] = None
        self._probes_in_flight = 0
        self._probe_successes = 0

    def _transition(self, state: str) -> None:
        self.state = state
        _labeled_counter("breaker_state",
                         {"replica": self.rid, "state": state})

    def allow(self) -> bool:
        """May the router dispatch to this replica right now?"""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if (self._opened_t is not None
                        and self._clock() - self._opened_t
                        >= self.cooldown_s):
                    self._transition("half_open")
                    self._probes_in_flight = 1
                    self._probe_successes = 0
                    return True
                return False
            # half-open: bounded concurrent probes
            if self._probes_in_flight < self.probes:
                self._probes_in_flight += 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self.state == "half_open":
                self._probes_in_flight = max(
                    0, self._probes_in_flight - 1)
                self._probe_successes += 1
                if self._probe_successes >= self.probes:
                    self._transition("closed")

    def record_failure(self) -> None:
        opened = False
        with self._lock:
            self._failures += 1
            if self.state == "half_open":
                self._probes_in_flight = max(
                    0, self._probes_in_flight - 1)
                self._opened_t = self._clock()
                self._transition("open")
                opened = True
            elif (self.state == "closed"
                    and self._failures >= self.threshold):
                self._opened_t = self._clock()
                self._transition("open")
                opened = True
            failures = self._failures
        if opened:
            record_fault("breaker_open", replica=self.rid,
                         model=self.model, failures=failures)


class ReplicaSupervisor:
    """The pool's self-healing brain (module docstring).  Built by
    :meth:`EnginePool.supervise`; hooks are called by the pool router
    with the pool lock held."""

    def __init__(self, pool, config: Optional[SupervisorConfig] = None,
                 clock=time.monotonic, sleep=time.sleep):
        self.pool = pool
        self.config = config or SupervisorConfig()
        self._clock = clock
        self._sleep = sleep
        # all guarded by pool._lock unless noted
        self._watchdogs: Dict[str, StallWatchdog] = {}
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._factories: Dict[str, Callable] = {}   # model -> engine fn
        self._lineage: Dict[str, int] = {}          # rid -> rebuilds so far
        self._latency: Dict[str, List[float]] = {}  # model -> recent e2e s
        self._orphans: List[tuple] = []             # (replica, future) legs
        self.incidents: List[Dict] = []
        self.crashes = 0
        self.wedges = 0
        self.restarts = 0
        self.permanent_quarantines = 0
        self.poison_rejects = 0
        self.failovers = 0
        self.hedges_launched = 0
        self.hedges_won = 0
        self._backoff_policy = fleet_backoff_policy(
            initial_delay_s=self.config.rebuild_backoff_initial_s,
            max_delay_s=self.config.rebuild_backoff_max_s,
            max_retries=max(1, self.config.max_rebuilds))
        self._workers: List[threading.Thread] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="pool-supervisor", daemon=True)
        self._thread.start()

    # -- registration (pool lock held) -----------------------------------

    def register_rebuild(self, model: str, factory: Callable) -> None:
        """``factory() -> engine`` rebuilds a quarantined replica of
        ``model`` (the shared-snapshot sibling constructor in
        serve/cli.build_shared_pool).  No factory = quarantine without
        rebuild."""
        with self.pool._wake:
            self._factories[model] = factory

    def track(self, replica) -> None:
        if replica.kind == "remote":
            self._breakers[replica.rid] = CircuitBreaker(
                replica.rid, replica.model,
                threshold=self.config.breaker_failure_threshold,
                cooldown_s=self.config.breaker_cooldown_s,
                probes=self.config.breaker_halfopen_probes,
                clock=self._clock)
            return
        wd = StallWatchdog(label=f"pool-replica-{replica.rid}", k=1.0,
                           min_beats=1,
                           floor_s=max(self._wedge_timeout_s(), 0.001),
                           clock=self._clock)
        wd.beat()   # arm: the first dispatch creates interval #1
        self._watchdogs[replica.rid] = wd

    def untrack(self, rid: str) -> None:
        self._watchdogs.pop(rid, None)
        self._breakers.pop(rid, None)

    def _wedge_timeout_s(self) -> float:
        if self.config.wedge_timeout_s:
            return self.config.wedge_timeout_s
        pool_cfg = self.pool.config
        return (pool_cfg.health_max_queue_age_s
                or getattr(self.pool._sched_template,
                           "health_max_queue_age_s", 0) or 0.0)

    # -- router hooks (pool lock held) -----------------------------------

    def allows(self, replica) -> bool:
        breaker = self._breakers.get(replica.rid)
        return breaker is None or breaker.allow()

    def on_dispatch(self, replica) -> None:
        wd = self._watchdogs.get(replica.rid)
        if wd is not None:
            wd.beat()

    def on_success(self, replica, e2e_s: Optional[float]) -> None:
        wd = self._watchdogs.get(replica.rid)
        if wd is not None:
            wd.beat()
        breaker = self._breakers.get(replica.rid)
        if breaker is not None:
            breaker.record_success()
        if e2e_s is not None:
            ring = self._latency.setdefault(replica.model, [])
            ring.append(e2e_s)
            if len(ring) > 512:
                del ring[: len(ring) - 512]

    def handle_failure(self, ticket, replica, err: BaseException) -> bool:
        """Classify a failed replica leg.  Returns True when the
        supervisor took ownership of the ticket (requeued for failover
        or typed-rejected); False = request-level error, the pool
        propagates it as before."""
        if isinstance(err, (ServeError, ValueError, TypeError)):
            return False        # this REQUEST's error, not the replica's
        if replica.kind == "remote":
            # vendor transport failure: breaker bookkeeping (opening
            # records the breaker_open fault), then failover if a
            # sibling can still answer
            breaker = self._breakers.get(replica.rid)
            if breaker is not None:
                breaker.record_failure()
            if (ticket.failovers >= self.config.max_failovers
                    or not self._has_sibling(replica)):
                return False    # real vendor error propagates typed
            self._failover_locked(ticket)
            return True
        # local crash: the engine call raised a non-request error
        self._quarantine_locked(replica, reason="crash", detection_ms=0.0,
                                error=str(err)[:160])
        ticket.kills += 1
        if ticket.kills >= self.config.poison_kill_limit:
            self._reject_poison_locked(ticket, err)
        else:
            self._failover_locked(ticket)
        return True

    def handle_hedge_failure(self, replica, err: BaseException) -> None:
        """A losing hedge leg failed: classify for the REPLICA only —
        the request is still racing on its primary leg, so nothing
        resolves here."""
        if isinstance(err, (ServeError, ValueError, TypeError)):
            return
        if replica.kind == "remote":
            breaker = self._breakers.get(replica.rid)
            if breaker is not None:
                breaker.record_failure()
            return
        self._quarantine_locked(replica, reason="crash", detection_ms=0.0,
                                error=str(err)[:160])

    def reclaim_locked(self, ticket) -> None:
        """Failover one leg stranded (unresolved) on a quarantined
        replica: the wedged batch and anything queued behind it."""
        ticket.kills += 1
        ticket.replica_future = None
        ticket.replica = None
        ticket.dispatch_t = None
        if ticket.kills >= self.config.poison_kill_limit:
            self._reject_poison_locked(ticket, None)
        else:
            self._failover_locked(ticket)

    def note_hedge_won(self, ticket) -> None:
        self.hedges_won += 1
        _labeled_counter("pool_hedges_won", {"model": ticket.model})

    def orphan_leg(self, replica, future: ScoreFuture) -> None:
        """Track a losing hedge/failover leg so its replica's
        ``outstanding`` drops when the leg eventually resolves."""
        self._orphans.append((replica, future))

    # -- failure plumbing (pool lock held) -------------------------------

    def _has_sibling(self, replica) -> bool:
        # any live sibling counts — a decode specialist CAN answer a
        # fresh prompt in a pinch (always-answered beats role purity);
        # _pick_sibling still prefers prefill/general capacity
        return any(r is not replica and r.model == replica.model
                   and r.state == "live"
                   for r in self.pool._replicas.values())

    def _failover_locked(self, ticket) -> None:
        ticket.failovers += 1
        self.failovers += 1
        ticket.replica_future = None
        ticket.replica = None
        ticket.dispatch_t = None
        _labeled_counter("pool_failovers", {"model": ticket.model})
        self.pool._queues[ticket.model].appendleft(ticket)

    def _reject_poison_locked(self, ticket, err) -> None:
        self.poison_rejects += 1
        record_fault("pool_poison_request", model=ticket.model,
                     kills=ticket.kills,
                     error=str(err)[:160] if err else None)
        ticket.future._set_exception(PoisonousRequest(
            f"request crashed/wedged {ticket.kills} replicas of "
            f"{ticket.model!r} (ceiling "
            f"{self.config.poison_kill_limit}); rejecting instead of "
            f"killing another"))

    def _quarantine_locked(self, replica, reason: str,
                           detection_ms: float,
                           error: Optional[str] = None) -> None:
        if replica.state != "live":
            return              # already quarantined/draining/closed
        # ONE incident per replica failure, however many stranded legs
        # observe it: the crash/wedge counters and their fault events
        # live here, behind the state check
        if reason == "crash":
            self.crashes += 1
            record_fault("pool_replica_crash", replica=replica.rid,
                         model=replica.model, error=error)
        else:
            self.wedges += 1
            record_fault("pool_replica_wedged", replica=replica.rid,
                         model=replica.model,
                         idle_ms=round(detection_ms, 1))
        replica.state = "quarantined"
        # sticky marker surviving shutdown()'s state="closed": the pool
        # reap distinguishes a quarantined corpse from a normal unload
        replica.quarantined = True
        incident = {"replica": replica.rid, "model": replica.model,
                    "reason": reason,
                    "detection_ms": round(detection_ms, 3),
                    "t_detect": self._clock()}
        self.incidents.append(incident)
        worker = threading.Thread(
            target=self._rebuild_worker, args=(replica, incident),
            name=f"pool-rebuild-{replica.rid}", daemon=True)
        self._workers.append(worker)
        worker.start()

    # -- quarantine / rebuild worker -------------------------------------

    def _teardown(self, replica, release_params) -> None:
        try:
            replica.shutdown(drain=False, release_params=release_params)
        except Exception:  # graftlint: disable=G05 quarantine teardown: a wedged engine may fail mid-close; the replica is being discarded either way and the rebuild must proceed
            pass

    def _rebuild_worker(self, replica, incident: Dict) -> None:
        t0 = self._clock()
        model = replica.model
        with self.pool._wake:
            births = self._lineage.pop(replica.rid, 0)
            factory = self._factories.get(model)
            self.untrack(replica.rid)
        if factory is None or births >= self.config.max_rebuilds:
            with self.pool._wake:
                # supervisor counters ride the POOL's lock (class
                # docstring): this worker thread races stats() readers
                # and sibling rebuild workers on the same field
                # (G09 serve/supervisor.py 'self.permanent_quarantines += 1')
                self.permanent_quarantines += 1
            record_fault(
                "pool_replica_quarantined", replica=replica.rid,
                model=model, rebuilds=births, permanent=True,
                reason=("no rebuild factory" if factory is None
                        else f"rebuild ceiling {self.config.max_rebuilds}"))
            # permanent: this lineage's shared-tree ref really releases
            self._teardown(replica, release_params=None)
            with self.pool._wake:
                self.pool._replicas.pop(replica.rid, None)
                self.pool._wake.notify_all()
            return
        # rebuild path: the dead sibling's share-group slot transfers to
        # its successor (release_params=False skips release_one), so the
        # shared param tree survives however the quarantines interleave
        self._teardown(
            replica,
            release_params=False if replica.share_group is not None
            else None)
        with self.pool._wake:
            self.pool._replicas.pop(replica.rid, None)
            self.pool._wake.notify_all()
        self._sleep(fleet_backoff_delay(births, self._backoff_policy))
        try:
            engine = factory()
            new = self.pool.load(model, engine,
                                 owns_engine=replica.owns_engine,
                                 plan_note=replica.plan_note,
                                 share_group=replica.share_group,
                                 role=getattr(replica, "role", None),
                                 devices=getattr(replica, "devices",
                                                 None))
        except Exception as err:  # graftlint: disable=G05 rebuild must never crash the supervisor: a failed factory (pool closed, OOM on reload) downgrades to permanent quarantine, recorded below
            if replica.share_group is not None:
                replica.share_group.release_one()
            with self.pool._wake:
                self.permanent_quarantines += 1
            record_fault("pool_replica_quarantined", replica=replica.rid,
                         model=model, rebuilds=births, permanent=True,
                         reason=f"rebuild failed: {str(err)[:120]}")
            return
        with self.pool._wake:
            self._lineage[new.rid] = births + 1
            # restarts and the incident row are pool-lock-guarded state
            # too: stats() snapshots both while this worker finishes
            self.restarts += 1
            incident["restart_ms"] = round(
                (self._clock() - t0) * 1000.0, 3)
        _labeled_counter("pool_replica_restarts",
                         {"replica": new.rid, "model": model})

    # -- monitor thread ---------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.config.poll_s):
            try:
                self._check_wedges()
                self._reap_orphans()
                if self.config.hedge:
                    self._scan_hedges()
            except Exception:  # graftlint: disable=G05 the monitor must survive any single check failing (a replica closing mid-scan): self-healing that dies on its first race heals nothing
                pass

    def _check_wedges(self) -> None:
        if self._wedge_timeout_s() <= 0:
            return
        with self.pool._wake:
            for replica in list(self.pool._replicas.values()):
                wd = self._watchdogs.get(replica.rid)
                if (wd is None or replica.state != "live"
                        or (replica.outstanding <= 0
                            and replica.queue_depth() <= 0)):
                    continue
                now = self._clock()
                if wd.check(now):
                    staleness_ms = ((now - wd._last_beat) * 1000.0
                                    if wd._last_beat else 0.0)
                    self._quarantine_locked(replica, reason="wedge",
                                            detection_ms=staleness_ms)
            self.pool._wake.notify_all()

    def _reap_orphans(self) -> None:
        with self.pool._wake:
            still = []
            for replica, future in self._orphans:
                if not future.done():
                    still.append((replica, future))
                    continue
                replica.outstanding = max(0, replica.outstanding - 1)
                breaker = self._breakers.get(replica.rid)
                if breaker is not None:
                    if future.exception(timeout=0) is None:
                        breaker.record_success()
                    else:
                        breaker.record_failure()
            self._orphans = still

    def _p99_s(self, model: str) -> Optional[float]:
        ring = self._latency.get(model)
        if not ring or len(ring) < self.config.hedge_min_samples:
            return None
        ordered = sorted(ring)
        return ordered[min(len(ordered) - 1,
                           int(0.99 * len(ordered)))]

    def _scan_hedges(self) -> None:
        with self.pool._wake:
            now = self._clock()
            for ticket in self.pool._inflight:
                if (ticket.hedge_future is not None
                        or ticket.dispatch_t is None
                        or ticket.replica is None):
                    continue
                p99 = self._p99_s(ticket.model)
                if p99 is None:
                    continue
                if now - ticket.dispatch_t <= self.config.hedge_k * p99:
                    continue
                sibling = self._pick_sibling(ticket)
                if sibling is None:
                    continue
                hedge_ticket = dataclasses.replace(
                    ticket, replica_future=None, hedge_future=None,
                    hedge_replica=None)
                if ticket.deadline is not None:
                    hedge_ticket.request = dataclasses.replace(
                        ticket.request,
                        timeout_s=max(0.0, ticket.deadline - now))
                try:
                    hf = sibling.dispatch(hedge_ticket)
                except ServeError:
                    continue    # sibling backpressure: try next tick
                ticket.hedge_future = hf
                ticket.hedge_replica = sibling
                sibling.outstanding += 1
                self.hedges_launched += 1

    def _pick_sibling(self, ticket):
        """Least-loaded live sibling for a hedge/failover leg, with the
        router's role affinity: a fresh-prompt leg lands on a decode
        specialist only when no prefill/general sibling is available."""
        cfg = self.pool.config
        best, best_score = None, None
        decode_best, decode_best_score = None, None
        for replica in self.pool._replicas.values():
            if (replica is ticket.replica
                    or replica.model != ticket.model
                    or replica.state != "live"
                    or not self.allows(replica)):
                continue
            score = (cfg.latency_weight * replica.predicted_wait_s()
                     + cfg.cost_weight
                     * replica.cost_estimate_usd(ticket.request)
                     * cfg.cost_scale_s_per_usd)
            if getattr(replica, "role", None) == "decode":
                if decode_best_score is None or score < decode_best_score:
                    decode_best, decode_best_score = replica, score
                continue
            if best_score is None or score < best_score:
                best, best_score = replica, score
        return best if best is not None else decode_best

    # -- reporting / lifecycle -------------------------------------------

    def breaker_states(self) -> Dict[str, str]:
        return {rid: b.state for rid, b in self._breakers.items()}

    def report(self) -> Dict:
        """The ``recovery`` block (bench --serve-load-replicas): every
        number a round-over-round diff needs to prove the fleet healed.
        ``requests_lost`` is filled by the harness (submitted minus
        answered-or-typed-rejected); the supervisor's own invariant is
        that it is structurally zero."""
        detection = [i["detection_ms"] for i in self.incidents
                     if "detection_ms" in i]
        restart = [i["restart_ms"] for i in self.incidents
                   if "restart_ms" in i]

        def stats(vals):
            if not vals:
                return None
            return {"mean": round(sum(vals) / len(vals), 3),
                    "max": round(max(vals), 3), "n": len(vals)}

        return {
            "incidents": len(self.incidents),
            "crashes": self.crashes,
            "wedges": self.wedges,
            "restarts": self.restarts,
            "permanent_quarantines": self.permanent_quarantines,
            "poison_rejects": self.poison_rejects,
            "requests_failed_over": self.failovers,
            "requests_lost": 0,
            "hedges_launched": self.hedges_launched,
            "hedges_won": self.hedges_won,
            "detection_ms": stats(detection),
            "restart_ms": stats(restart),
            "breaker_states": self.breaker_states(),
        }

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._thread.join(timeout=timeout)
        with self.pool._wake:
            # snapshot under the pool lock: _quarantine_locked appends
            # rebuild workers to this list from the router thread
            workers = list(self._workers)
        for worker in workers:
            worker.join(timeout=timeout)
