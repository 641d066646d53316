"""Pipelining and the OOM back-off ladder of the port's engine.

Model, tokenizer, prompts and per-prompt targets are those of
``tests/test_torch_slots.py``.  Rows must not depend on
``pipeline_depth``; a device out-of-memory error injected at batches above
8 rows must step the batch down the ladder and give the rows of an engine
run at batch 8 (the same batches, so the same numbers), with the fault
events the JAX engine records under the same injection.  An OOM inside the
pooled decode, which holds rows of many batches, and any other error
propagate.
"""

import numpy as np
import pytest
import torch

from llm_interpretation_replication_tpu.runtime import batching as jbatching
from llm_interpretation_replication_tpu.runtime import engine as jengine
from llm_interpretation_replication_tpu.runtime import faults as jfaults
from llm_interpretation_replication_tpu_torch.runtime import batching
from llm_interpretation_replication_tpu_torch.runtime import engine as tengine
from llm_interpretation_replication_tpu_torch.runtime import faults
from llm_interpretation_replication_tpu_torch.runtime import slots as tslots
from llm_interpretation_replication_tpu_torch.utils import telemetry as ttel
from test_torch_slots import (PROMPTS, TOK, assert_rows_match, engines,
                              one_torch_thread, targets)  # noqa: F401

# (route name, EngineConfig overrides); the pool target is fixed so that the
# ring's capacity does not follow the batch size the ladder steps to
ROUTES = {
    "ring": dict(phase2_pool_target=8),
    "flush": dict(phase2_pool_target=8, slot_repack=False),
    "per-batch": dict(phase2_pool=False),
}
EVENT_FIELDS = ("kind", "batch", "new_batch", "bucket_len", "rows")


def _score(eng):
    return eng.score_prompts(PROMPTS, list(targets()))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_rows_identical_across_pipeline_depths(route):
    rows = {}
    for depth in (1, 2, 4):
        _, teng = engines(batch_size=4, pipeline_depth=depth, **ROUTES[route])
        rows[depth] = (_score(teng), teng.occupancy_report())
    assert rows[1] == rows[2] == rows[4]


def _oom_above(fn, make_error, rows=8, at=2):
    """``fn`` that raises ``make_error()`` when argument ``at`` (the token
    ids) has more than ``rows`` rows."""
    def wrapped(*args, **kwargs):
        if args[at].shape[0] > rows:
            raise make_error()
        return fn(*args, **kwargs)
    return wrapped


def _inject(monkeypatch, route):
    """OOM at the port's (and the JAX engine's) prefill above 8 rows."""
    torch_oom = lambda: torch.OutOfMemoryError("CUDA out of memory (injected)")
    jax_oom = lambda: RuntimeError("RESOURCE_EXHAUSTED: injected")
    if route == "per-batch":
        monkeypatch.setattr(tengine.dmod, "prefill",
                            _oom_above(tengine.dmod.prefill, torch_oom))
        monkeypatch.setattr(jengine.ScoringEngine, "_prefill", _oom_above(
            jengine.ScoringEngine._prefill, jax_oom, at=1))
    else:
        monkeypatch.setattr(tengine, "_prefill_select",
                            _oom_above(tengine._prefill_select, torch_oom))
        monkeypatch.setattr(jengine, "_prefill_select",
                            _oom_above(jengine._prefill_select, jax_oom))


def _events(events):
    return [{k: e[k] for k in EVENT_FIELDS} for e in events]


@pytest.mark.parametrize("ladder", [(), (12,)])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_injected_oom_steps_down_the_ladder(monkeypatch, route, ladder):
    """Batch 16 runs out of memory; the ladder steps it to 8 (through 12
    when the ladder names it): rows equal an unconstrained run at batch 8,
    and the fault events carry the JAX engine's fields and values (held
    against the JAX engine without a ladder; the ladder's steps against
    their expected sizes)."""
    want = _score(engines(batch_size=8, **ROUTES[route])[1])
    jeng, teng = engines(batch_size=16, oom_batch_ladder=ladder,
                         **ROUTES[route])
    _inject(monkeypatch, route)
    got = _score(teng)
    assert got == want
    events = _events(teng.fault_events)
    if not ladder:
        assert_rows_match(got, _score(jeng))
        assert events == _events(jeng.fault_events)
    steps = [(e["batch"], e["new_batch"]) for e in events]
    assert steps and set(steps) == ({(16, 8)} if not ladder
                                    else {(16, 12), (12, 8)})
    assert sum(e["rows"] for e in events if e["batch"] == 16) == len(PROMPTS)
    assert ttel.fault_events("engine_oom_backoff")[-len(events):] == \
        teng.fault_events


@pytest.mark.parametrize("override", [dict(oom_batch_floor=16),
                                      dict(oom_backoff=False)])
def test_oom_without_a_step_propagates(monkeypatch, override):
    """At the floor, or with back-off off, the OOM reaches the caller."""
    _, teng = engines(batch_size=16, **ROUTES["ring"], **override)
    _inject(monkeypatch, "ring")
    with pytest.raises(torch.OutOfMemoryError):
        _score(teng)
    assert teng.fault_events == []


@pytest.mark.parametrize("route", ["ring", "flush"])
def test_pooled_decode_oom_is_not_rebatched(monkeypatch, route):
    """An OOM in the pooled decode, which holds rows of earlier batches, is
    marked ``_no_rebatch`` and propagates: stepping down the batch that
    triggered it cannot shrink it."""
    _, teng = engines(batch_size=4, phase2_pool_target=4,
                      **{k: v for k, v in ROUTES[route].items()
                         if k != "phase2_pool_target"})

    def decode_oom(*args, **kwargs):
        raise torch.OutOfMemoryError("CUDA out of memory (injected)")

    monkeypatch.setattr(tengine.dmod, "decode_steps", decode_oom)
    with pytest.raises(torch.OutOfMemoryError) as info:
        _score(teng)
    assert info.value._no_rebatch is True
    assert teng.fault_events == []


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_non_oom_error_propagates(monkeypatch, route):
    _, teng = engines(batch_size=4, **ROUTES[route])

    def broken(*args, **kwargs):
        raise ValueError("shape mismatch (injected)")

    monkeypatch.setattr(tengine.dmod, "prefill", broken)
    with pytest.raises(ValueError, match="injected"):
        _score(teng)
    assert teng.fault_events == []


@pytest.mark.parametrize("err,port,reference", [
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
     True, False),
    (torch.OutOfMemoryError("allocation failed"), True, False),
    (RuntimeError("CUDA out of memory. Tried to allocate 20.00 MiB"), True,
     False),
    (RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating 4 GiB"),
     True, True),
    (RuntimeError("ResourceExhausted"), True, True),
    (MemoryError("Resource exhausted: Out of memory"), True, True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     False, False),
    (ValueError("shape mismatch"), False, False),
])
def test_is_oom(err, port, reference):
    """The port also knows PyTorch's spellings of a device OOM; the
    reference's status spellings classify the same in both."""
    assert faults.is_oom(err) is port
    assert jfaults.is_oom(err) is reference
    assert faults.oom_detail(err) == jfaults.oom_detail(err)


@pytest.mark.parametrize("batch,ladder,floor", [
    (32, (), 8), (16, (), 8), (8, (), 8), (64, (48, 32), 8),
    (40, (48, 32), 8), (20, (), 0), (3, (), 1), (12, (16,), 4),
])
def test_next_batch_down_matches_reference(batch, ladder, floor):
    assert faults.next_batch_down(batch, ladder, floor) == \
        jfaults.next_batch_down(batch, ladder, floor)


@pytest.mark.parametrize("length_sorted", [True, False])
def test_rebatch_matches_reference(length_sorted):
    encoded = [TOK(p)["input_ids"] for p in PROMPTS]
    for batch in batching.batches_for_prompts(encoded, 16, (32, 64),
                                              length_sorted=length_sorted):
        got = batching.rebatch(batch, encoded, 8, (32, 64),
                               length_sorted=length_sorted)
        ref = jbatching.rebatch(batch, encoded, 8, (32, 64),
                                length_sorted=length_sorted)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.bucket_len == r.bucket_len
            for f in ("token_ids", "attention_mask", "indices"):
                np.testing.assert_array_equal(getattr(g, f), getattr(r, f))


def test_telemetry_counters_and_labeled_twins():
    """``slot_counter`` records a counter and its labeled twin;
    ``counters_since`` reports deltas, and after a clear the current
    value, never a negative delta."""
    snap = ttel.counters()
    tslots.slot_counter("slot_rows", 3, "binary", "engine")
    delta = ttel.counters_since(snap)
    assert delta["slot_rows"] == 3
    assert delta["slot_rows|leg=binary,workload=engine"] == 3
    before = ttel.counters()
    ttel.clear_counters()
    ttel.record_counter("slot_rows", 2)
    assert ttel.counters_since(before)["slot_rows"] == 2
    event = ttel.record_fault("engine_oom_backoff", batch=4)
    assert ttel.fault_events("engine_oom_backoff")[-1] is event
