"""Fault-injection fixtures for tests and driver dryruns (the JAX
package's ``utils/testing.py``, without ``build_inprocess_tokenizer``: it
trains a ``tokenizers`` BPE, and the port's tests use
``utils.tokenizer.WordTokenizer`` instead).

:class:`FaultyEngine` wraps an engine and injects device OOM, SIGTERM
preemption, transient errors and NaN probabilities on a schedule, at the
sweep-call or the device-batch granularity.  :class:`BreakableEngine`
kills or wedges a whole pool replica on demand, and :class:`FlakyVendor`
is a remote backend with togglable outages: together they pin the serve
scheduler's, the pool's and the supervisor's recovery paths against a
tiny CPU model.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import threading
import time
from typing import List, Optional, Sequence


# ---------------------------------------------------------------------------
# Fault-injection harness
# ---------------------------------------------------------------------------

def injected_oom_error() -> RuntimeError:
    """A RESOURCE_EXHAUSTED spelling ``faults.is_oom`` classifies as a
    device OOM, like ``torch.OutOfMemoryError`` on the card."""
    return RuntimeError(
        "RESOURCE_EXHAUSTED: Out of memory allocating device buffer "
        "(injected by FaultyEngine)")


@dataclasses.dataclass
class Fault:
    """One scheduled fault.

    ``kind``:
      - ``"oom"``       raise a fake RESOURCE_EXHAUSTED
      - ``"transient"`` raise a :class:`~..runtime.faults.TransientError`
      - ``"preempt"``   deliver SIGTERM to this process (so installed
                        :class:`~..runtime.faults.PreemptionGuard` handlers
                        flush); raises ``Preempted`` directly when no
                        handler is installed (never kills the test runner)
      - ``"nan"``       delegate the call, then overwrite every probability
                        field with NaN — the observable effect of NaN logits

    Exactly one trigger: ``at_call`` (1-based index over the engine's
    score_prompts / first_token_relative_prob calls — sweep-chunk
    granularity) or ``at_batch`` (1-based device-batch launch inside the
    engine — the granularity the engine's OOM back-off operates at).
    ``times`` repeats the fault on consecutive matching triggers."""

    kind: str
    at_call: int = 0
    at_batch: int = 0
    times: int = 1
    fired: int = 0

    def __post_init__(self):
        if self.kind not in ("oom", "transient", "preempt", "nan"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if (self.at_call > 0) == (self.at_batch > 0):
            raise ValueError("specify exactly one of at_call / at_batch")
        if self.kind == "nan" and self.at_batch:
            raise ValueError("nan faults operate at call granularity")


class FaultyEngine:
    """Duck-typed engine wrapper injecting faults on a schedule.

    Wraps any engine the sweep shells accept (a real ScoringEngine or a
    test fake) and delegates everything, counting ``calls`` (score_prompts
    and first_token_relative_prob invocations, shared counter — the same
    numbering bench's regression tests use) and ``batches`` (device-batch
    launches, by hooking the engine's ``_run_pipelined`` chokepoint when it
    has one — installed only for the duration of THIS wrapper's calls, so
    discarding the wrapper leaves the engine clean and no stale unfired
    ``at_batch`` fault can ambush a later direct use of the engine).
    Faults fire per their schedule; everything injected is recorded on
    ``self.injected`` for assertions."""

    def __init__(self, engine, faults: Sequence[Fault] = ()):
        self.engine = engine
        self.faults = list(faults)
        self.calls = 0
        self.batches = 0
        self.injected: List[dict] = []
        self._hook_batches = any(f.at_batch for f in self.faults)
        # expose score_prefixed ONLY when the wrapped engine has it, so
        # hasattr probes (the sweeps' fused-path capability check) see the
        # same surface as the bare engine — a FakeEngine without the fused
        # path keeps routing sweeps through the legacy string path
        if hasattr(engine, "score_prefixed"):
            self.score_prefixed = self._score_prefixed

    @contextlib.contextmanager
    def _batch_hook(self):
        """Shadow the engine's ``_run_pipelined`` with the batch-counting
        hook for one delegated call, restoring the original on exit."""
        if not self._hook_batches or not hasattr(self.engine,
                                                 "_run_pipelined"):
            yield
            return
        real_run = self.engine._run_pipelined

        def run(batches, launch, consume, rebatch=None):
            def counting_launch(batch):
                self.batches += 1
                self._maybe_fire(at_batch=self.batches)
                return launch(batch)
            return real_run(batches, counting_launch, consume,
                            rebatch=rebatch)

        self.engine._run_pipelined = run
        try:
            yield
        finally:
            self.engine.__dict__.pop("_run_pipelined", None)

    # -- delegation ------------------------------------------------------

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def score_prompts(self, prompts, targets=("Yes", "No"),
                      with_confidence=False, max_new_tokens=None, **kw):
        self.calls += 1
        nan = self._take(at_call=self.calls, kinds=("nan",))
        self._maybe_fire(at_call=self.calls)
        kwargs = dict(targets=targets, with_confidence=with_confidence, **kw)
        if max_new_tokens is not None:  # old-signature engines keep working
            kwargs["max_new_tokens"] = max_new_tokens
        with self._batch_hook():
            rows = self.engine.score_prompts(prompts, **kwargs)
        if nan is not None:
            self._record(nan, at_call=self.calls)
            for row in rows:
                for key in ("yes_prob", "no_prob", "relative_prob",
                            "odds_ratio", "first_token_yes_prob",
                            "first_token_no_prob",
                            "first_token_relative_prob"):
                    if key in row:
                        row[key] = float("nan")
        return rows

    def _score_prefixed(self, pairs, targets=("Yes", "No"), legs=None, **kw):
        """Fused-path injection point (installed as ``score_prefixed`` when
        the wrapped engine has one): shares the call counter and fault
        schedule with score_prompts — a sweep chunk is one call either
        way — and hooks device-batch launches identically."""
        self.calls += 1
        nan = self._take(at_call=self.calls, kinds=("nan",))
        self._maybe_fire(at_call=self.calls)
        with self._batch_hook():
            outs = self.engine.score_prefixed(pairs, targets=targets,
                                              legs=legs, **kw)
        if nan is not None:
            self._record(nan, at_call=self.calls)
            for rows in outs:
                for row in rows:
                    for key in ("yes_prob", "no_prob", "relative_prob",
                                "odds_ratio", "first_token_yes_prob",
                                "first_token_no_prob",
                                "first_token_relative_prob"):
                        if key in row:
                            row[key] = float("nan")
        return outs

    def serve_scheduler(self, config=None):
        """Serve-path injection point: a continuous-batching scheduler
        (serve/.Scheduler) built over THIS wrapper, so scheduler-driven
        micro-batches launch through the counting/injecting
        ``score_prompts`` / ``score_prefixed`` above — ``at_call`` and
        ``at_batch`` faults fire inside serve launches exactly as they do
        inside sweep calls, and the fault matrix covers the scheduler's
        own recovery paths (OOM → split + queue re-entry, transient →
        in-place retry) with the same schedules."""
        from ..serve import Scheduler

        return Scheduler(self, config)

    def first_token_relative_prob(self, prompts, targets=("Yes", "No"),
                                  top_filter: int = 0):
        self.calls += 1
        nan = self._take(at_call=self.calls, kinds=("nan",))
        self._maybe_fire(at_call=self.calls)
        with self._batch_hook():
            out = self.engine.first_token_relative_prob(
                prompts, targets=targets, top_filter=top_filter)
        if nan is not None:
            self._record(nan, at_call=self.calls)
            out = out * float("nan")
        return out

    # -- scheduling ------------------------------------------------------

    def _take(self, at_call: int = 0, at_batch: int = 0,
              kinds: Sequence[str] = ("oom", "transient", "preempt")
              ) -> Optional[Fault]:
        for f in self.faults:
            if f.fired >= f.times or f.kind not in kinds:
                continue
            if at_call and f.at_call == at_call:
                f.fired += 1
                return f
            if at_batch and f.at_batch == at_batch:
                f.fired += 1
                return f
        return None

    def _record(self, fault: Fault, **where):
        self.injected.append({"kind": fault.kind, **where})

    def _maybe_fire(self, at_call: int = 0, at_batch: int = 0) -> None:
        fault = self._take(at_call=at_call, at_batch=at_batch)
        if fault is None:
            return
        self._record(fault, at_call=at_call, at_batch=at_batch)
        if fault.kind == "oom":
            raise injected_oom_error()
        if fault.kind == "transient":
            from ..runtime.faults import TransientError

            raise TransientError("injected transient fault (FaultyEngine)")
        if fault.kind == "preempt":
            from ..runtime.faults import Preempted

            handler = signal.getsignal(signal.SIGTERM)
            if callable(handler):
                # a real handler is installed (e.g. PreemptionGuard): deliver
                # the actual signal so its flush path runs; the handler's
                # raise surfaces out of the sleep below
                os.kill(os.getpid(), signal.SIGTERM)
                deadline = time.monotonic() + 2.0
                while time.monotonic() < deadline:
                    time.sleep(0.01)  # handler raises from in here
            # SIG_DFL/SIG_IGN would kill (or ignore in) the test runner;
            # simulate the preemption exit instead
            raise Preempted(signal.SIGTERM)


# ---------------------------------------------------------------------------
# Pool-level fault harness (fleet self-healing, serve/supervisor.py)
# ---------------------------------------------------------------------------

class BreakableEngine:
    """Duck-typed engine wrapper a test can KILL or WEDGE at will.

    :class:`FaultyEngine` injects faults the ENGINE-level ladder recovers
    from (OOM back-off, transient retry); this wrapper injects the faults
    that kill a whole POOL REPLICA so the supervisor's quarantine /
    rebuild / failover paths can be pinned:

    - :meth:`kill` — every subsequent scoring call raises a non-request
      ``RuntimeError`` (the supervisor classifies it as a replica CRASH);
    - :meth:`wedge` — every subsequent scoring call BLOCKS (a hung
      device: no beats while busy → the supervisor's wedge watchdog);
    - :meth:`heal` — back to delegation; unblocks a wedged call so a
      quarantined replica's bounded teardown can complete in tests;
    - ``poison_marker`` — any batch whose prompt contains this substring
      crashes the call wherever it lands: the SAME request killing
      replica after replica, which is exactly the poison-row ceiling's
      trigger (``SupervisorConfig.poison_kill_limit``).

    ``crashes`` counts injected kills for assertions.  Factories built
    from this wrapper (one per replica) drive the failover matrix of the
    pool's tests."""

    def __init__(self, engine, poison_marker: Optional[str] = None):
        self.engine = engine
        self.poison_marker = poison_marker
        self.mode = "ok"               # ok | dead | wedged
        self.crashes = 0
        self._unwedge = threading.Event()
        self._unwedge.set()
        if hasattr(engine, "score_prefixed"):
            self.score_prefixed = self._score_prefixed
        # real engines expose the slot-admission entry the serve
        # scheduler PREFERS over score_prompts; a plain __getattr__
        # delegation would bypass the fault gate entirely
        if hasattr(engine, "score_prompts_slotted"):
            self.score_prompts_slotted = self._score_prompts_slotted

    # -- fault controls --------------------------------------------------

    def kill(self) -> None:
        self.mode = "dead"

    def wedge(self) -> None:
        self._unwedge.clear()
        self.mode = "wedged"

    def heal(self) -> None:
        self.mode = "ok"
        self._unwedge.set()

    # -- injection gate --------------------------------------------------

    def _crash(self, why: str) -> "RuntimeError":
        self.crashes += 1
        return RuntimeError(
            f"replica engine crashed: {why} (injected by BreakableEngine)")

    def _text(self, prompt) -> str:
        # the pool coalescer pre-tokenizes on the submit thread whenever
        # the engine has a tokenizer, so by the time a real engine is
        # called the "prompt" is a token-id list — decode it back or the
        # poison marker is invisible on exactly the engines that matter
        if isinstance(prompt, str):
            return prompt
        if isinstance(prompt, (tuple, list)) and all(
                isinstance(x, str) for x in prompt):
            return "".join(prompt)       # un-encoded suffix tuple
        tok = getattr(self.engine, "tokenizer", None)
        if tok is None:
            return ""
        try:
            return tok.decode(list(prompt))
        except Exception:
            return ""

    def _gate(self, prompts: Sequence) -> None:
        if self.mode == "dead":
            raise self._crash("killed")
        if self.mode == "wedged":
            # block like a hung device until heal(); the scheduler's
            # coalescer thread sits here, so the replica makes no
            # progress beats while busy — the wedge watchdog's signature
            self._unwedge.wait()
            if self.mode == "dead":
                raise self._crash("killed while wedged")
        if self.poison_marker and any(
                self.poison_marker in self._text(p) for p in prompts):
            raise self._crash(f"poison marker {self.poison_marker!r}")

    # -- delegation ------------------------------------------------------

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def score_prompts(self, prompts, **kw):
        self._gate(prompts)
        return self.engine.score_prompts(prompts, **kw)

    def _score_prefixed(self, pairs, **kw):
        self._gate([f"{self._text(p)}{self._text(s)}" for p, s in pairs])
        return self.engine.score_prefixed(pairs, **kw)

    def _score_prompts_slotted(self, prompts, **kw):
        self._gate(prompts)
        return self.engine.score_prompts_slotted(prompts, **kw)

    def first_token_relative_prob(self, prompts, **kw):
        self._gate(prompts)
        return self.engine.first_token_relative_prob(prompts, **kw)


class FlakyVendor:
    """A togglable-outage ``evaluate`` callable for
    :class:`~..serve.pool.RemoteBackend` — the vendor-side twin of
    :class:`BreakableEngine` that drives the circuit-breaker tests.

    Usable directly as ``RemoteBackend("vendor-model", FlakyVendor())``.
    Set ``down = True`` for a hard outage (every call raises a transport
    ``RuntimeError``) or ``fail_next = N`` for a bounded burst; calls and
    failures are counted for breaker-threshold assertions."""

    def __init__(self, yes_prob: float = 0.9, no_prob: float = 0.1,
                 latency_s: float = 0.0):
        self.yes_prob = yes_prob
        self.no_prob = no_prob
        self.latency_s = latency_s
        self.down = False
        self.fail_next = 0
        self.calls = 0
        self.failures = 0

    def __call__(self, prompt, targets, with_confidence, max_new_tokens):
        self.calls += 1
        if self.down or self.fail_next > 0:
            if self.fail_next > 0:
                self.fail_next -= 1
            self.failures += 1
            raise RuntimeError(
                "vendor unavailable: injected 503 (FlakyVendor)")
        if self.latency_s:
            time.sleep(self.latency_s)
        return {"yes_prob": self.yes_prob, "no_prob": self.no_prob,
                "response": "Yes" if self.yes_prob >= self.no_prob
                else "No"}
