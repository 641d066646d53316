"""The port's strict mode (``runtime/strict.py``) and the telemetry it
reports through, against the JAX package's.

On the CPU PyTorch's sync debug mode has nothing to guard (CPU tensors
never make the host wait), so these tests drive the counting machinery
with an op that raises PyTorch's sync-debug message, check the mode the
guards set around the engine's launch and consume callbacks, and hold a
strict, traced sweep to ``blocked_transfers == 0`` with its rows equal to
an unguarded run's.  The card's own check (a real ``.item()`` tripping the
guard) is ``chip_smoke.py``'s obs phase.  The telemetry the strict report
embeds (sample rings, histograms, fault listeners) is held against the
JAX package's on the same seeded streams.
"""

import os
import stat

import numpy as np
import pytest

from llm_interpretation_replication_tpu.runtime import strict as jstrict
from llm_interpretation_replication_tpu.utils import telemetry as jtel
from llm_interpretation_replication_tpu_torch import obs
from llm_interpretation_replication_tpu_torch.models import decoder as dmod
from llm_interpretation_replication_tpu_torch.ops import _build
from llm_interpretation_replication_tpu_torch.runtime import engine as tengine
from llm_interpretation_replication_tpu_torch.runtime import strict
from llm_interpretation_replication_tpu_torch.sweeps import perturbation as tsweep
from llm_interpretation_replication_tpu_torch.utils import telemetry as ttel
from test_torch_slots import one_torch_thread  # noqa: F401
from test_torch_sweep import MODEL, SWEEP_KW, engines, quiet, scenarios


def sync_error():
    """What PyTorch raises for a synchronizing CUDA operation under sync
    debug mode "error"."""
    return RuntimeError("CUDA error: called a synchronizing CUDA operation")


@pytest.fixture(autouse=True)
def _inactive():
    from llm_interpretation_replication_tpu_torch.obs import flight

    strict.deactivate()
    obs.disable()
    obs.get_tracer().reset()
    yield
    strict.deactivate()
    obs.disable()
    obs.get_tracer().reset()
    # the sweeps arm the flight recorder at their workbooks' directory
    flight.get_recorder().wait()
    flight.disable()


def _blocked():
    return int(ttel.counter(strict.BLOCKED_COUNTER))


# -- the guards ---------------------------------------------------------------

def test_guard_trip_counts_once_and_propagates():
    strict.activate(sentry=False)
    before = _blocked()
    faults_before = len(ttel.fault_events("blocked_transfer"))
    with pytest.raises(RuntimeError, match="synchronizing CUDA operation"):
        with strict.scoring_guard("outer"):
            with strict.scoring_guard("inner"):
                raise sync_error()
    assert _blocked() == before + 1
    events = ttel.fault_events("blocked_transfer")[faults_before:]
    assert [e["label"] for e in events] == ["inner"]
    with pytest.raises(ValueError):             # another error: not counted
        with strict.scoring_guard():
            raise ValueError("not a sync")
    with pytest.raises(RuntimeError):
        with strict.device_region("probe"):
            raise RuntimeError("called a synchronizing CUDA operation")
    assert _blocked() == before + 2
    strict.deactivate()
    with pytest.raises(RuntimeError):           # inactive: not counted
        with strict.scoring_guard():
            raise RuntimeError("called a synchronizing CUDA operation")
    assert _blocked() == before + 2


def test_sanctioned_fetch_restores_the_outer_mode():
    base = strict.sync_debug_mode()
    with strict.scoring_guard():                # inactive: no change
        assert strict.sync_debug_mode() == base
    strict.activate(sentry=False)
    with strict.scoring_guard():
        assert strict.sync_debug_mode() == 2
        with strict.sanctioned_fetch():
            assert strict.sync_debug_mode() == 0
            with strict.scoring_guard():
                assert strict.sync_debug_mode() == 2
            assert strict.sync_debug_mode() == 0
        assert strict.sync_debug_mode() == 2
        with pytest.raises(KeyError):
            with strict.sanctioned_fetch():
                raise KeyError("x")
        assert strict.sync_debug_mode() == 2
    assert strict.sync_debug_mode() == base


def test_engine_launch_is_guarded_and_consume_sanctioned(monkeypatch):
    """The pipeline's launch runs at mode "error", its consume at 0; a
    sync error in a launch path propagates out of ``score_prompts`` and is
    counted once."""
    _, teng = engines()
    prompts = [f"{r} {s['response_format']}" for s in scenarios()
               for r in s["rephrasings"]][:6]
    seen = {"launch": set(), "consume": set()}
    real_prefill, real_consume = dmod.prefill, teng._consume_scored_batch

    def prefill(*a, **k):
        seen["launch"].add(strict.sync_debug_mode())
        return real_prefill(*a, **k)

    def consume(*a, **k):
        seen["consume"].add(strict.sync_debug_mode())
        return real_consume(*a, **k)

    monkeypatch.setattr(dmod, "prefill", prefill)
    monkeypatch.setattr(teng, "_consume_scored_batch", consume)
    strict.activate(sentry=False)
    rows = teng.score_prompts(prompts)
    assert all(r["success"] for r in rows)
    assert seen == {"launch": {2}, "consume": {0}}

    def tripping(*a, **k):
        raise sync_error()

    before = _blocked()
    monkeypatch.setattr(dmod, "prefill", tripping)
    with pytest.raises(RuntimeError, match="synchronizing"):
        teng.score_prompts(prompts)
    assert _blocked() == before + 1
    assert strict.sync_debug_mode() == 0


def test_strict_traced_sweep_has_zero_blocked_transfers(tmp_path):
    """A strict sweep traced in sync mode and metered keeps
    ``blocked_transfers == 0``, and its rows equal the plain run's."""
    from llm_interpretation_replication_tpu_torch.obs import metrics

    _, teng = engines()

    def sweep(name):
        return tsweep.run_model_perturbation_sweep(
            teng, MODEL, scenarios(), str(tmp_path / f"{name}.xlsx"),
            log=quiet(), **SWEEP_KW)

    plain = sweep("plain")
    strict.activate()
    obs.enable(sync=True, memory=True)
    metrics.enable_jsonl(str(tmp_path / "m.jsonl"))
    snap = ttel.counters()
    try:
        guarded = sweep("strict")
    finally:
        metrics.get_registry().disable_jsonl()
    delta = ttel.counters_since(snap)
    assert delta.get(strict.BLOCKED_COUNTER, 0) == 0
    assert delta.get(strict.RECOMPILE_COUNTER, 0) == 0
    assert guarded == plain
    report = strict.strict_report()
    assert report["enabled"] and report[strict.BLOCKED_COUNTER] == _blocked()
    names = {s["name"] for s in obs.get_tracer().spans()}
    assert {"launch", "consume", "prefill", "build_rows"} <= names
    with open(tmp_path / "m.jsonl") as f:
        assert sum(1 for line in f if line.strip()) == 3   # one a chunk


def test_strict_report_keys_match_reference():
    strict.activate(sentry=False)
    jstrict.activate(sentry=False)
    try:
        assert set(strict.strict_report()) - {"samples"} == \
            set(jstrict.strict_report()) - {"samples"}
        ttel.record_sample("strict_keys_ring", 1.0)
        jtel.record_sample("strict_keys_ring", 1.0)
        t, j = strict.strict_report(), jstrict.strict_report()
        assert set(t) == set(j)
        assert t["samples"]["strict_keys_ring"] == \
            j["samples"]["strict_keys_ring"]
    finally:
        jstrict.deactivate()


@pytest.mark.parametrize("value", [None, "", "0", "off", "1", "yes", " On "])
def test_env_gate_matches_reference(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(strict.STRICT_ENV, raising=False)
    else:
        monkeypatch.setenv(strict.STRICT_ENV, value)
    assert strict.env_requests_strict() == jstrict.env_requests_strict()
    assert strict.activate_from_env() == strict.env_requests_strict()


def test_recompile_sentry_counts_nvcc_builds(tmp_path, monkeypatch):
    """While strict mode is armed, every ``nvcc`` build ``ops/_build.py``
    starts lands in ``recompile_events`` under its source's name; a warm
    repeat (built in this process, or found on disk) builds nothing."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_records", {})
    strict.activate()
    before = int(ttel.counter(strict.RECOMPILE_COUNTER))
    names = ["causal_grouped_attention", "head_major_attention"]
    recs = _build.build_all(names)
    assert all(os.path.exists(r.path) for r in recs.values())
    assert int(ttel.counter(strict.RECOMPILE_COUNTER)) == before + 2
    assert strict.sentry_programs()[-2:] == names
    _build.build_all(names)                      # warm in this process
    monkeypatch.setattr(_build, "_records", {})
    _build.build_all(names)                      # warm on disk
    assert int(ttel.counter(strict.RECOMPILE_COUNTER)) == before + 2
    strict.deactivate()
    assert not _build._listeners
    monkeypatch.setattr(_build, "_records", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build2"))
    _build.build_all(names[:1])                  # disarmed: not counted
    assert int(ttel.counter(strict.RECOMPILE_COUNTER)) == before + 2


# -- telemetry against the JAX package ---------------------------------------

def _streams(seed):
    rng = np.random.default_rng(seed)
    return {"lat_ms": rng.lognormal(2.0, 1.0, 700).tolist(),
            "depth": rng.integers(0, 40, 300).astype(float).tolist(),
            "tiny": rng.uniform(0, 2e-3, 50).tolist()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_rings_and_histograms_match_reference(seed):
    streams = _streams(seed)
    for mod in (ttel, jtel):
        mod.clear_samples()
        mod.clear_hists()
        mod.set_sample_cap(256, name="lat_ms")
        for name, values in streams.items():
            for v in values:
                mod.record_sample(name, v)
                mod.record_hist(name, v)
    try:
        for name in streams:
            assert ttel.sample_cap(name) == jtel.sample_cap(name)
            assert ttel.sample_count(name) == jtel.sample_count(name)
            assert ttel.sample_total(name) == jtel.sample_total(name)
            for last in (None, 10, 0):
                assert ttel.sample_percentiles(name, last=last) == \
                    jtel.sample_percentiles(name, last=last)
            assert ttel.hist_counts(name) == jtel.hist_counts(name)
            assert ttel.hist_percentiles(name) == jtel.hist_percentiles(name)
            assert ttel.hist_percentiles_from(ttel.hist_counts(name), (1.0,)) \
                == jtel.hist_percentiles_from(jtel.hist_counts(name), (1.0,))
        assert ttel.sample_ring_report() == jtel.sample_ring_report()
        assert ttel.hist_report() == jtel.hist_report()
        for i in range(0, 200, 7):
            assert ttel.hist_bucket_le(i) == jtel.hist_bucket_le(i)
    finally:
        for mod in (ttel, jtel):
            mod.set_sample_cap(mod._SAMPLES_CAP_DEFAULT, name="lat_ms")
            mod.clear_samples()
            mod.clear_hists()


def test_fault_listeners_and_memory_summary():
    got = []
    ttel.add_fault_listener(got.append)
    ttel.add_fault_listener(got.append)          # idempotent

    def broken(event):
        raise RuntimeError("a listener never breaks the fault path")

    ttel.add_fault_listener(broken)
    try:
        ev = ttel.record_fault("transient_retry", label="x")
    finally:
        ttel.remove_fault_listener(got.append)
        ttel.remove_fault_listener(broken)
    ttel.record_fault("transient_retry", label="y")
    assert got == [ev]
    assert ttel.FAULT_KINDS == jtel.FAULT_KINDS
    assert ttel.device_memory_summary() is None          # no card here
    assert ttel.get_memory_usage().endswith("HBM: n/a")
    ttel.clear_host_memory()


# -- per-thread modes ---------------------------------------------------------

def _jax_mode():
    """The calling thread's device-to-host guard in the JAX package, as a
    sync debug mode (``"disallow"`` 2, ``"allow"`` or unset 0)."""
    from jax._src import config as jconfig

    return {"disallow": 2}.get(jconfig.transfer_guard_device_to_host.value, 0)


class _FakeCuda:
    """A card's process-wide sync debug mode, for the registry's sake."""

    def __init__(self):
        self.mode = 0
        self.history = []

    def is_available(self):
        return True

    def get_sync_debug_mode(self):
        return self.mode

    def set_sync_debug_mode(self, mode):
        self.mode = strict._MODES.get(mode, mode)
        self.history.append(self.mode)


def _choreograph(mod, read, plan, card=None):
    """Run ``plan`` — a list of ``(thread, action)`` steps, action one of
    ``"guard"``, ``"fetch"``, ``"exit"`` or ``"read"`` — on one thread a
    name, strictly in order (each step waits for the one before it).
    Returns each thread's readings and, with a fake ``card``, the card's
    mode after every step."""
    import threading

    done = [threading.Event() for _ in plan]
    reads = {name: [] for name, _ in plan}
    card_modes, errors = [], []

    def run(name):
        open_ = []
        try:
            for i, (who, action) in enumerate(plan):
                if who != name:
                    continue
                if i:
                    assert done[i - 1].wait(10), "choreography stalled"
                if action in ("guard", "fetch"):
                    cm = (mod.scoring_guard(name) if action == "guard"
                          else mod.sanctioned_fetch())
                    cm.__enter__()
                    open_.append(cm)
                elif action == "exit":
                    open_.pop().__exit__(None, None, None)
                reads[name].append(read())
                if card is not None:
                    card_modes.append(card.mode)
                done[i].set()
        except BaseException as err:       # surfaced by the main thread
            errors.append(err)
            for ev in done:
                ev.set()

    threads = [threading.Thread(target=run, args=(n,)) for n in reads]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert not errors, errors
    return reads, card_modes


# A enters a guard, B a sanctioned fetch, then they exit: in that order,
# with A leaving first, in the mirror (B first in, B first out) and nested.
ORDERS = {
    "guard_exits_first": [("A", "guard"), ("B", "fetch"), ("A", "read"),
                          ("B", "read"), ("A", "exit"), ("B", "exit")],
    "mirror": [("B", "fetch"), ("A", "guard"), ("A", "read"), ("B", "read"),
               ("B", "exit"), ("A", "exit")],
    "fetch_exits_first": [("A", "guard"), ("B", "fetch"), ("A", "read"),
                          ("B", "read"), ("B", "exit"), ("A", "exit")],
}


@pytest.mark.parametrize("order", sorted(ORDERS))
def test_each_thread_reads_its_own_mode(order):
    """Thread A inside a guard reads 2 and thread B inside a sanctioned
    fetch reads 0 whatever the other does, as the JAX package's
    per-thread transfer guards read ``"disallow"`` and ``"allow"``; after
    both exit, every thread reads 0."""
    plan = ORDERS[order]
    strict.activate(sentry=False)
    jstrict.activate(sentry=False)
    try:
        port, _ = _choreograph(strict, strict.sync_debug_mode, plan)
        ref, _ = _choreograph(jstrict, _jax_mode, plan)
    finally:
        jstrict.deactivate()
    assert port == ref
    a_in = plan.index(("A", "read"))
    b_in = plan.index(("B", "read"))
    assert port["A"][[i for i, (w, _) in enumerate(plan)
                      if w == "A"].index(a_in)] == 2
    assert port["B"][[i for i, (w, _) in enumerate(plan)
                      if w == "B"].index(b_in)] == 0
    assert port["A"][-1] == 0 and port["B"][-1] == 0
    assert strict.sync_debug_mode() == 0 and _jax_mode() == 0
    assert not strict._REGIONS and strict._BASE is None


@pytest.mark.parametrize("order", sorted(ORDERS))
def test_card_mode_follows_the_registry(monkeypatch, order):
    """With a card, the process-wide mode is "error" only while some
    thread sits in a guard and none in a sanctioned fetch, and returns to
    the mode found before the first region."""
    card = _FakeCuda()
    card.mode = 1                           # "warn", set by someone before
    monkeypatch.setattr(strict, "torch", type("T", (), {"cuda": card}))
    strict.activate(sentry=False)
    plan = ORDERS[order]
    reads, modes = _choreograph(strict, strict.sync_debug_mode, plan, card)
    inside = {}
    for (who, action), mode in zip(plan, modes):
        if action in ("guard", "fetch"):
            inside.setdefault(who, []).append(action)
        elif action == "exit":
            inside[who].pop()
        inner = {v[-1] for v in inside.values() if v}
        expect = 2 if "guard" in inner and "fetch" not in inner else 1
        assert mode == expect, (who, action, mode)
    assert card.mode == 1
    assert reads["A"][-1] == 1 and reads["B"][-1] == 1
    assert not strict._REGIONS and strict._BASE is None


@pytest.mark.parametrize("seed", range(4))
def test_random_interleavings_restore_the_mode(monkeypatch, seed):
    """Three threads with nested guards and fetches in a seeded random
    interleaving: no thread reads another's mode, a fetch never runs with
    the card at "error", and the mode found before comes back."""
    rng = np.random.default_rng(seed)
    card = _FakeCuda()
    monkeypatch.setattr(strict, "torch", type("T", (), {"cuda": card}))
    strict.activate(sentry=False)
    depth = {n: [] for n in "ABC"}
    plan = []
    while len(plan) < 30 or any(depth.values()):
        who = "ABC"[rng.integers(3)]
        if len(plan) < 30 and (not depth[who] or rng.random() < 0.5):
            action = ("guard", "fetch")[rng.integers(2)]
            depth[who].append(action)
        elif depth[who]:
            action = "exit"
            depth[who].pop()
        else:
            continue
        plan.append((who, action))
    reads, modes = _choreograph(strict, strict.sync_debug_mode, plan, card)
    stacks = {n: [] for n in "ABC"}
    it = {n: iter(reads[n]) for n in "ABC"}
    for (who, action), mode in zip(plan, modes):
        if action == "exit":
            stacks[who].pop()
        else:
            stacks[who].append(action)
        own = next(it[who])
        want = {"guard": 2, "fetch": 0}[stacks[who][-1]] if stacks[who] else 0
        assert own == want
        if any(s and s[-1] == "fetch" for s in stacks.values()):
            assert mode == 0
    assert card.mode == 0 and not strict._REGIONS
