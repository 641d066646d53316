"""Stdlib-only JSONL driver for the ``serve`` CLI subcommand (the JAX
package's ``serve/cli.py`` on the port's engine).

One request per input line::

    {"prompt": "Is a tweet a publication? ...", "targets": ["Yes", "No"]}
    {"prefix": "Is soup a beverage?", "suffix": " Answer Yes or No.",
     "with_confidence": false, "max_new_tokens": 10,
     "priority": 5, "timeout_s": 30.0}

One result per output line, in INPUT order, each echoing the 0-based
input ``id``: the engine's ordinary result-row dict on success, or
``{"id": N, "error": "...", "error_type": "DeadlineExceeded"}`` on a
typed rejection — a request is always answered, never dropped.

The replay entry (``serve --replay perturbations.json``) rebuilds the
perturbation sweep's prompt workload exactly as the offline sweep shell
does and routes it through :func:`..serve.replay.replay`, asserting
row-level parity and reporting scheduler-vs-offline throughput.

On a mesh of ranks (``torchrun`` with ``--mesh-model``/``--mesh-seq``)
every rank builds the same replay corpus, and only the mesh's leader
reads ``--input`` (its lines reach the other ranks on the control
channel where they need them), writes ``--output``, serves
``--metrics-port``, draws ``--load-rate``'s arrivals and prints the
report; the other ranks follow its scheduler (serve/scheduler.py) and
exit with its code.
"""

from __future__ import annotations

import contextlib
import json
import sys
from typing import Dict, Optional

from ..parallel import mesh as pmesh
from . import load as load_mod
from .config import SchedulerConfig
from .replay import replay
from .request import ScoreRequest, ServeError
from .scheduler import Scheduler

#: request-line keys accepted by :func:`parse_request_line`
#: ("model" routes a line to an EnginePool replica under
#: --pool-replicas; inert on a single-engine scheduler)
_REQUEST_KEYS = ("prompt", "prefix", "suffix", "targets",
                 "with_confidence", "max_new_tokens", "priority",
                 "timeout_s", "model")


def parse_request_line(obj: Dict) -> ScoreRequest:
    unknown = set(obj) - set(_REQUEST_KEYS)
    if unknown:
        raise ValueError(f"unknown request field(s): {sorted(unknown)}")
    kw = {k: obj[k] for k in _REQUEST_KEYS if k in obj}
    if "targets" in kw:
        kw["targets"] = tuple(kw["targets"])
    req = ScoreRequest(**kw)
    req.validate()
    return req


def scheduler_health(sched) -> Dict:
    """The scheduler's /healthz contribution: liveness + queue depth +
    the OLDEST queued request's age.  Depth alone reads a wedged
    coalescer with a short queue as healthy; a head request older than
    ``SchedulerConfig.health_max_queue_age_s`` degrades the document
    (the endpoint reports degraded, never 500s — obs/metrics.py)."""
    doc = {"scheduler": "closed" if sched._closed else "running",
           "queue_depth": len(sched.queue)}
    age = sched.queue.oldest_wait_s()
    max_age = getattr(sched.config, "health_max_queue_age_s", 0)
    if age is not None:
        doc["oldest_queued_age_s"] = round(age, 3)
        if max_age and age > max_age:
            doc["status"] = "degraded"
            doc["degraded_reason"] = (
                f"oldest queued request has waited {age:.1f}s "
                f"(> {max_age:g}s threshold)")
    return doc


def _metrics_endpoint(sched, port: int, healthz_fn=None):
    """``/metrics`` + ``/healthz`` for a live scheduler (obs/metrics.py):
    the Prometheus exposition over the telemetry counters, serve sample
    rings, and latency-anatomy histograms, plus a periodic sampler
    feeding the registry's time-series.  ``healthz_fn`` overrides the
    health contributor (the EnginePool hands its per-replica document);
    default: :func:`scheduler_health` over ``sched``.  Returns the
    started server (caller closes), or None when ``port`` is falsy."""
    if not port:
        return None
    from ..obs import metrics as obs_metrics

    registry = obs_metrics.get_registry()
    registry.start_sampler()
    server = obs_metrics.MetricsServer(
        registry, port,
        healthz_fn=healthz_fn or (lambda: scheduler_health(sched))).start()
    print(f"# serve: metrics on :{server.port}/metrics, health on "
          f"/healthz", file=sys.stderr)
    return server


def _mesh(engine):
    """The engine's mesh when it has more than one rank, else None."""
    mesh = getattr(engine, "mesh", None)
    return mesh if mesh is not None and mesh.size() > 1 else None


def _sibling(engine):
    """A fresh :class:`~..runtime.engine.ScoringEngine` around ``engine``'s
    weights, tokenizer, operating point, device and K-head (the tensors
    are shared, not copied)."""
    from ..runtime.engine import ScoringEngine

    sibling = ScoringEngine(
        engine.family, engine.cfg, engine.params, engine.tokenizer,
        mesh=engine.mesh, engine_config=engine.ecfg, device=engine.device)
    sibling.k_head = engine.k_head
    sibling.plan_decision = getattr(engine, "plan_decision", None)
    return sibling


def shared_sibling_factory(engine):
    """A rebuild factory over ONE loaded snapshot: each call constructs
    a fresh sibling (:func:`_sibling`) on the same device.  This is what
    the supervisor runs to resurrect a quarantined replica — the shared
    tensors are still alive (the dead sibling's share-group slot
    transfers to its successor), so a rebuild costs a scheduler, never a
    second weight load."""
    return lambda: _sibling(engine)


def build_shared_pool(engine, model: str, replicas: int,
                      config: Optional[SchedulerConfig] = None,
                      supervise=None):
    """An :class:`~.pool.EnginePool` of ``replicas`` local replicas of
    ONE loaded snapshot: siblings share the param tree (no extra weight
    HBM on the same devices — the arrays are the same buffers), each
    behind its own scheduler with ``{replica, model}`` metric labels.
    Ownership of the shared buffers is REFCOUNTED
    (:class:`~.pool.ParamShareGroup`): only the last sibling to unload
    releases them, whatever order the operator hot-unloads in.  Every
    sibling inherits the primary's engine config, device, K-head and
    plan note.

    ``supervise`` arms fleet self-healing (serve/supervisor.py): pass
    ``True`` for the default :class:`~.supervisor.SupervisorConfig` or a
    config instance; the shared-snapshot sibling constructor doubles as
    the rebuild factory, so a crashed or wedged replica comes back
    without reloading weights."""
    from .pool import EnginePool, ParamShareGroup, PoolConfig
    from .supervisor import SupervisorConfig

    n = max(1, replicas)
    group = ParamShareGroup(n)
    sup_cfg = None
    if supervise:
        sup_cfg = (supervise if isinstance(supervise, SupervisorConfig)
                   else SupervisorConfig())
    pool = EnginePool(PoolConfig(scheduler=config, supervision=sup_cfg))
    pool.load(model, engine, share_group=group,
              plan_note=getattr(engine, "plan_decision", None))
    for _ in range(1, n):
        pool.load(model, _sibling(engine), share_group=group,
                  plan_note=engine.plan_decision)
    if pool.supervisor is not None:
        pool.supervisor.register_rebuild(model, shared_sibling_factory(engine))
    return pool


def run_jsonl_driver(engine, in_stream, out_stream,
                     config: Optional[SchedulerConfig] = None,
                     metrics_port: int = 0, pool=None) -> Dict:
    """Read JSONL requests, serve them, write JSONL results in input
    order.  Returns ``{"requests": N, "errors": M}``.  With ``pool``
    the requests route through the EnginePool front door instead of a
    fresh single-engine scheduler (lines may carry ``"model"``), and
    /healthz serves the pool's per-replica document; the pool's
    lifetime belongs to the caller."""
    entries = []  # (id, future-or-None, error-or-None)
    metrics_server = None
    try:
        with (contextlib.nullcontext(pool) if pool is not None
              else Scheduler(engine, config)) as sched:
            metrics_server = _metrics_endpoint(
                sched, metrics_port,
                healthz_fn=pool.health if pool is not None else None)
            for i, line in enumerate(in_stream):
                line = line.strip()
                if not line:
                    continue
                try:
                    future = sched.submit(
                        parse_request_line(json.loads(line)))
                    entries.append((i, future, None))
                except (ValueError, KeyError, TypeError, ServeError) as err:
                    # malformed line, OR a typed admission rejection
                    # (QueueFull backpressure / SchedulerClosed): this line
                    # gets its error answer and the driver keeps going —
                    # already-admitted requests must still be served
                    entries.append((i, None, err))
            results = []
            for i, future, parse_err in entries:
                if parse_err is not None:
                    results.append((i, None, parse_err))
                    continue
                try:
                    results.append((i, future.result(timeout=None), None))
                except Exception as err:  # graftlint: disable=G05 CLI result relay: every per-request failure (typed rejection or engine error) becomes that request's JSON error line; the driver must answer the remaining lines
                    results.append((i, None, err))
    finally:
        if metrics_server is not None:
            metrics_server.close()
            # the periodic sampler _metrics_endpoint started must die
            # with the endpoint, or it keeps accumulating series for a
            # scraper that no longer exists
            from ..obs import metrics as obs_metrics

            obs_metrics.get_registry().stop_sampler()
    errors = 0
    for i, row, err in results:
        if err is not None:
            errors += 1
            out_stream.write(json.dumps(
                {"id": i, "error": str(err),
                 "error_type": type(err).__name__}) + "\n")
        else:
            out_stream.write(json.dumps({"id": i, **row}) + "\n")
    return {"requests": len(results), "errors": errors}


def run_replay(engine, perturbations_path: str,
               max_rephrasings: Optional[int] = None,
               config: Optional[SchedulerConfig] = None,
               require_parity: bool = True) -> Dict:
    """Replay the perturbation sweep's binary-leg workload through the
    scheduler (the prompts the offline shell builds: ``{rephrasing}
    {response_format}`` with per-scenario target pairs — ONE builder,
    shared with the load harness: :func:`..serve.load.corpus_workload`)
    and return the parity + throughput report."""
    prompts, targets = load_mod.corpus_workload(
        perturbations_path, max_rephrasings=max_rephrasings)
    report = replay(engine, prompts, targets=targets, config=config,
                    require_parity=require_parity)
    report.pop("serve_rows", None)
    return report


def run_load_cli(engine, args, config: SchedulerConfig, pool=None) -> int:
    """``serve --load-rate``: the open-loop load harness (serve/load.py)
    over the perturbation corpus (``--replay PATH`` supplies it) or the
    ``--input`` JSONL request lines as the prompt pool.  A single rate
    runs one operating point; a comma-separated list of >= 3 walks the
    rate sweep and reports the knee.  Exits 1 on a parity mismatch.
    With ``pool`` (``--pool-replicas``) the SAME harness drives the
    EnginePool front door via ``pool.client()``; ``engine`` stays the
    offline parity reference."""
    rates = [float(r) for r in str(args.load_rate).split(",") if r.strip()]
    if not rates:
        print("# serve load: --load-rate parsed to no rates; pass one "
              "rate or a comma list of >= 3", file=sys.stderr)
        return 2
    if 1 < len(rates) < 3:
        # never silently drop a requested rate: a sweep needs >= 3 points
        # to bracket a knee, one point runs alone — two is ambiguous
        print(f"# serve load: --load-rate with multiple rates needs >= 3 "
              f"to bracket a knee (got {len(rates)}); pass one rate or "
              f"add a third", file=sys.stderr)
        return 2
    mesh = _mesh(engine)
    leads = pmesh.is_leader(mesh)
    if args.replay:
        prompts, targets = load_mod.corpus_workload(
            args.replay, max_rephrasings=args.max_rephrasings)
    elif not leads:
        # the offline parity pass is an engine call: every rank needs the
        # leader's prompt pool
        prompts, targets = pmesh.decide(None, mesh)
    else:
        prompts, targets = [], []
        stream = sys.stdin if args.input == "-" else open(
            args.input, encoding="utf-8")
        try:
            for line in stream:
                line = line.strip()
                if not line:
                    continue
                req = parse_request_line(json.loads(line))
                if req.prompt is None:
                    raise ValueError(
                        "load mode pools plain-prompt request lines; "
                        "prefix/suffix pairs are not poolable")
                prompts.append(req.prompt)
                targets.append(tuple(req.targets))
        finally:
            if stream is not sys.stdin:
                stream.close()
        pmesh.decide((prompts, targets), mesh)
    if not prompts:
        print("# serve load: empty prompt pool (need --replay or "
              "--input lines)", file=sys.stderr)
        return 2
    # --metrics-port works in load mode too: the latency-anatomy
    # histogram families exported on /metrics exist exactly for a
    # scraper watching a load run.  The scheduler is created inside
    # run_load per rate point, so /healthz carries the generic liveness
    # document (no per-scheduler queue health here).
    server = None
    if getattr(args, "metrics_port", 0) and leads:
        from ..obs import metrics as obs_metrics

        registry = obs_metrics.get_registry()
        registry.start_sampler()
        server = obs_metrics.MetricsServer(
            registry, args.metrics_port).start()
        print(f"# serve load: metrics on :{server.port}/metrics",
              file=sys.stderr)
    try:
        kw = dict(duration_s=args.load_duration, seed=args.load_seed,
                  config=config, jsonl=getattr(args, "load_jsonl", None))
        if pool is not None:
            kw["scheduler_factory"] = lambda cfg: pool.client()
        if len(rates) >= 3:
            block = load_mod.rate_sweep(engine, prompts, targets=targets,
                                        rates=rates,
                                        closed_comparator=True, **kw)
            ok = block.get("parity_ok") in (True, None)
            if leads:
                print(load_mod.format_rate_table(block), file=sys.stderr)
                print(json.dumps(block, indent=2))
        else:
            report = load_mod.run_load(engine, prompts, targets=targets,
                                       rate=rates[0], **kw)
            parity = report.get("parity")
            ok = parity is None or parity["mismatched_rows"] == 0
            if leads:
                print(json.dumps(report, indent=2))
        return 0 if pmesh.decide(ok, mesh) else 1
    finally:
        if server is not None:
            server.close()
            from ..obs import metrics as obs_metrics

            obs_metrics.get_registry().stop_sampler()


def main(engine, args) -> int:
    """The ``serve`` subcommand body (argparse args from __main__)."""
    config = SchedulerConfig(
        max_batch=args.max_batch,
        max_wait_s=args.max_wait_ms / 1000.0,
        queue_capacity=args.queue_capacity,
        default_timeout_s=args.timeout_s,
        slot_admission=not getattr(args, "no_slot_admission", False),
    )
    replicas = getattr(args, "pool_replicas", 0) or 0
    mesh = _mesh(engine)
    leads = pmesh.is_leader(mesh)
    if replicas > 1 and mesh is not None:
        raise ValueError(
            "--pool-replicas with --mesh-model/--mesh-seq: a pool's "
            "replicas on a mesh of ranks each take a slice of it "
            "(EnginePool.load(devices=), parallel.mesh.carve_slices), "
            "not one engine's mesh")
    pool = None
    # the bare --replay harness is single-engine parity by construction;
    # every other mode (JSONL driver, --load-rate — including load over
    # the --replay corpus) serves through the pool when asked
    if replicas > 1 and (getattr(args, "load_rate", None)
                         or not args.replay):
        supervise = bool(getattr(args, "supervise", False))
        pool = build_shared_pool(engine, getattr(args, "model", "model"),
                                 replicas, config, supervise=supervise)
        print(f"# serve: EnginePool with {replicas} replicas of "
              f"{getattr(args, 'model', 'model')} (shared snapshot"
              f"{', supervised' if supervise else ''})",
              file=sys.stderr)
    try:
        if getattr(args, "load_rate", None):
            return run_load_cli(engine, args, config, pool=pool)
        if args.replay:
            # require_parity=False: the CLI's job on a skew is the full
            # JSON report plus exit 1 — raising would swallow the report
            # the operator needs to see WHICH rows diverged.  (The replay
            # harness is single-engine by construction; --pool-replicas
            # is inert here.)
            report = run_replay(engine, args.replay,
                                max_rephrasings=args.max_rephrasings,
                                config=config, require_parity=False)
            if leads:
                print(json.dumps(report, indent=2))
            ok = pmesh.decide(report.get("mismatched_rows") == 0, mesh)
            return 0 if ok else 1
        if not leads:
            # a follower answers no client: it runs the leader's engine
            # calls until the leader closes
            Scheduler(engine, config).start().close()
            return 0
        in_stream = sys.stdin if args.input == "-" else open(
            args.input, encoding="utf-8")
        out_stream = sys.stdout if args.output == "-" else open(
            args.output, "w", encoding="utf-8")
        try:
            summary = run_jsonl_driver(engine, in_stream, out_stream,
                                       config,
                                       metrics_port=getattr(
                                           args, "metrics_port", 0) or 0,
                                       pool=pool)
        finally:
            if in_stream is not sys.stdin:
                in_stream.close()
            if out_stream is not sys.stdout:
                out_stream.close()
        print(f"# serve: {summary['requests']} request(s), "
              f"{summary['errors']} error(s)", file=sys.stderr)
        return 0
    finally:
        if pool is not None:
            pool.close()
