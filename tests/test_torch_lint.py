"""The port's linter (``llm_interpretation_replication_tpu_torch/lint/``)
against the reference's, and the port held to its own gate.

- Parity: the fixture sources of ``tests/test_lint.py`` for G00 and
  G05-G11 give the same findings (rule, line, column) through the
  reference's ``lint_source`` / ``collect_thread_findings`` and the
  port's.
- G01/G02 read for PyTorch: tensor syncs and tensor-valued control flow
  in ``launch`` regions are flagged; numpy values, ``consume`` closures,
  ``strict.sanctioned_fetch()`` blocks and helpers past the depth bound
  are not.  G03/G04 do not run and ``--explain`` says why.
- The baseline ratchet, the contracts layer's teeth, and the repo gate:
  no new finding over the port with ``lint_baseline_torch.json``, no
  G09-G11, a cycle-free lock graph, ``lint contracts`` clean.
- The two ``serve/pool.py`` races the linter found (G09), each pinned by a
  regression test ordered with events (twins of
  ``tests/test_lint.py::TestConcurrencyRegressions``).
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import types

import pytest

from llm_interpretation_replication_tpu.lint import (
    collect_thread_findings as ref_thread_findings,
    default_rules as ref_default_rules,
    lint_source as ref_lint_source,
)
from llm_interpretation_replication_tpu_torch.lint import (
    apply_baseline,
    collect_thread_findings,
    default_paths,
    default_rules,
    lint_paths,
    lint_source,
    load_baseline,
    model_from_paths,
    rotten_entries,
    save_baseline,
)
from llm_interpretation_replication_tpu_torch.lint import cli as lint_cli
from llm_interpretation_replication_tpu_torch.lint.contracts import (
    PKG_NAME,
    main as contracts_main,
)
from llm_interpretation_replication_tpu_torch.lint.visitor import (
    INTERPROCEDURAL_DEPTH,
)
from llm_interpretation_replication_tpu_torch.obs.tracer import KNOWN_PHASES
from test_lint import TestG05BroadExcept, _G09_RACE, _G10_CYCLE, _G11_SLEEP
from test_torch_slots import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.lint

REPO_ROOT = lint_cli.repo_root()


def _dedent(src):
    return textwrap.dedent(src)


# ---------------------------------------------------------------------------
# (a) parity with the reference on its own fixtures
# ---------------------------------------------------------------------------

_SWALLOW = TestG05BroadExcept.SWALLOW

#: a span a phase of the canonical table (tests/test_lint.py's
#: test_every_known_phase_passes, as one file)
_EVERY_PHASE = "from ..obs import tracer\n" + "".join(
    f"\ndef f{i}():\n    with tracer.span('x', phase={p!r}):\n        pass\n"
    for i, p in enumerate(sorted(KNOWN_PHASES)))

#: (path, source) of tests/test_lint.py's per-file fixtures for G00 and
#: G05-G08, the positive and the negative ones
FILE_FIXTURES = {
    "g00_syntax": ("m.py", "def f(:\n    pass\n"),
    "g05_runtime": ("runtime/thing.py", _SWALLOW),
    "g05_serve_scheduler": ("serve/scheduler.py", _SWALLOW),
    "g05_serve_load": ("serve/load.py", _SWALLOW),
    "g05_serve_pool": ("serve/pool.py", _SWALLOW),
    "g05_engine": ("runtime/engine.py", _SWALLOW),
    "g05_slots": ("runtime/slots.py", _SWALLOW),
    "g05_plan_search": ("runtime/plan_search.py", _SWALLOW),
    "g05_out_of_scope": ("viz/figures.py", _SWALLOW),
    "g05_reraise": ("runtime/thing.py", """
        def f():
            try:
                g()
            except Exception:
                cleanup()
                raise
    """),
    "g05_typed": ("runtime/thing.py", """
        def f():
            try:
                g()
            except (ValueError, OSError):
                return None
    """),
    "g05_bare": ("sweeps/s.py", """
        def f():
            try:
                g()
            except:
                pass
    """),
    "g05_suppressed": ("runtime/thing.py", """
        def f():
            try:
                g()
            # graftlint: disable=G05 deliberate keep-alive
            except Exception:
                return None
    """),
    "g05_trailing_suppressed": ("runtime/thing.py", """
        def f():
            try:
                g()
            except Exception:  # graftlint: disable=G05 keep-alive
                return None
    """),
    "g05_tuple_broad": ("runtime/thing.py", """
        def f():
            try:
                g()
            except (Exception, OSError):
                return None
    """),
    "g05_wrong_rule_suppressed": ("runtime/thing.py", """
        def f():
            try:
                g()
            except Exception:  # graftlint: disable=G01 wrong rule
                return None
    """),
    "g05_obs_tracer": ("obs/tracer.py", """
        def close_span(rec):
            try:
                rec.close()
            except Exception:
                pass
    """),
    "g05_obs_metrics": ("obs/metrics.py", """
        def sample_tick(reg):
            try:
                reg.sample()
            except Exception:
                pass
    """),
    "g05_scoring": ("scoring/packed.py", """
        def encode(tok, packs):
            try:
                return tok(packs)
            except Exception:
                return None
    """),
    "g05_decoder": ("models/decoder.py", """
        def verify(block):
            try:
                return block.accept()
            except Exception:
                return None
    """),
    "g06_concatenated": ("utils/m.py", """
        from .telemetry import record_counter

        def f(kind):
            record_counter("slot_" + kind)
    """),
    "g06_fstring_base": ("utils/m.py", """
        from .telemetry import record_counter

        def f(kind):
            record_counter(f"slot_{kind}")
    """),
    "g06_labeled_fstring": ("utils/m.py", """
        from .telemetry import record_counter

        def f(leg):
            record_counter(f"k_steps_saved|leg={leg}", 3)
    """),
    "g06_dynamic_label_key": ("utils/m.py", """
        from .telemetry import record_counter

        def f(k):
            record_counter(f"slot_rows|{k}=x", 1)
    """),
    "g06_malformed_labels": ("utils/m.py", """
        from .telemetry import record_counter

        def f():
            record_counter("slot_rows|leg confidence", 1)
    """),
    "g06_chokepoint": ("runtime/slots.py", """
        from ..utils.telemetry import record_counter

        def slot_counter(name, value, leg, workload):
            record_counter(f"{name}|leg={leg},workload={workload}",
                           value)
    """),
    "g06_module_constant": ("runtime/strict.py", """
        from ..utils.telemetry import record_counter

        RECOMPILE_COUNTER = "recompile_events"

        def f():
            record_counter(RECOMPILE_COUNTER)
    """),
    "g06_unresolvable": ("utils/m.py", """
        from .telemetry import record_counter

        def f():
            name = make_name()
            record_counter(name)
    """),
    "g06_unregistered_fault": ("serve/m.py", """
        from ..utils.telemetry import record_fault

        def f(rid):
            record_fault("pool_replica_crashd", replica=rid)
    """),
    "g06_registered_fault": ("serve/m.py", """
        from ..utils.telemetry import record_fault

        def f(rid, wedged):
            record_fault("pool_replica_wedged" if wedged
                         else "pool_replica_crash", replica=rid)
    """),
    "g06_dynamic_fault": ("serve/m.py", """
        from ..utils.telemetry import record_fault

        def f(kind, rid):
            record_fault(kind, replica=rid)
    """),
    "g06_ifexp": ("utils/m.py", """
        from .telemetry import record_counter

        def f(ok):
            record_counter("cache_hit" if ok else "cache_miss")
    """),
    "g07_reshape": ("runtime/m.py", """
        import jax.numpy as jnp

        def f(cache):
            return jnp.reshape(cache.k, (2, -1))
    """),
    "g07_concat_list": ("serve/m.py", """
        import jax.numpy as jnp

        def f(cache, other):
            return jnp.concatenate([cache.k, other.v], axis=1)
    """),
    "g07_ops_exempt": ("ops/quant.py", """
        import jax.numpy as jnp

        def f(cache):
            return jnp.reshape(cache.k, (2, -1))
    """),
    "g07_decoder_exempt": ("models/decoder.py", """
        import jax.numpy as jnp

        def cache_kv_map(cache, fn):
            return fn(cache.k)
    """),
    "g07_metadata": ("runtime/m.py", """
        import jax.numpy as jnp

        def f(cache):
            return jnp.zeros(cache.k.shape, cache.k.dtype)
    """),
    "g07_non_cache": ("runtime/m.py", """
        import jax.numpy as jnp

        def f(x):
            return jnp.reshape(x.k, (2, -1))
    """),
    "g08_unmanaged": ("runtime/m.py", """
        from ..obs import tracer

        def f():
            s = tracer.span("x", phase="decode")
            s.close()
    """),
    "g08_with": ("runtime/m.py", """
        from ..obs import tracer

        def f():
            with tracer.span("x", phase="decode"):
                pass
    """),
    "g08_enter_context": ("runtime/m.py", """
        def f(stack, obs):
            stack.enter_context(obs.span("x", phase="decode"))
    """),
    "g08_unknown_phase": ("runtime/m.py", """
        from ..obs import tracer

        def f():
            with tracer.span("x", phase="warmup_zap"):
                pass
    """),
    "g08_computed_phase": ("runtime/m.py", """
        from ..obs import tracer

        def f(p):
            with tracer.span("x", phase=p):
                pass
    """),
    "g08_every_known_phase": ("runtime/m.py", _EVERY_PHASE),
}

_W = _G09_RACE["pkg/w.py"]
_D = _G10_CYCLE["pkg/d.py"]
_S = _G11_SLEEP["pkg/s.py"]

#: {path: source} trees of tests/test_lint.py's G09-G11 fixtures
THREAD_FIXTURES = {
    "g09_race": {"pkg/w.py": _W},
    "g09_guarded": {"pkg/w.py": _W.replace(
        "    def bump(self):\n        self._n += 1",
        "    def bump(self):\n        with self._lock:\n"
        "            self._n += 1")},
    "g09_single_thread": {"pkg/w.py": _dedent("""
        class Counter:
            def __init__(self):
                self._n = 0

            def bump(self):
                self._n += 1
    """)},
    "g09_never_locked_rmw": {"pkg/w.py": _dedent("""
        import threading

        class Worker:
            def __init__(self):
                self._n = 0
                self._thread = threading.Thread(target=self._loop)

            def _loop(self):
                self._n += 1

            def bump(self):
                self._n += 1
    """)},
    "g09_plain_rebind": {"pkg/w.py": _dedent("""
        import threading

        class Worker:
            def __init__(self):
                self._flag = False
                self._thread = threading.Thread(target=self._loop)

            def _loop(self):
                while not self._flag:
                    pass

            def stop(self):
                self._flag = True
    """)},
    "g09_init_exempt": {"pkg/w.py": _W.replace(
        "    def bump(self):\n        self._n += 1",
        "    def snapshot(self):\n        with self._lock:\n"
        "            return self._n")},
    "g09_suppressed": {"pkg/w.py": _W.replace(
        "    def bump(self):\n        self._n += 1",
        "    def bump(self):\n"
        "        # graftlint: disable=G09 approximate stat\n"
        "        self._n += 1")},
    "g10_cycle": {"pkg/d.py": _D},
    "g10_consistent": {"pkg/d.py": _D.replace(
        "        with self._lb:\n            with self._la:",
        "        with self._la:\n            with self._lb:")},
    "g10_call_edge": {"pkg/d.py": _dedent("""
        import threading

        _LA = threading.Lock()
        _LB = threading.Lock()

        def _grab_b():
            with _LB:
                pass

        def ab():
            with _LA:
                _grab_b()

        def ba():
            with _LB:
                with _LA:
                    pass
    """)},
    "g10_relock": {"pkg/d.py": _dedent("""
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()

            def outer(self):
                with self._lock:
                    self.inner()

            def inner(self):
                with self._lock:
                    pass
    """)},
    "g10_rlock": {"pkg/d.py": _dedent("""
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.RLock()

            def outer(self):
                with self._lock:
                    self.inner()

            def inner(self):
                with self._lock:
                    pass
    """)},
    "g11_sleep": {"pkg/s.py": _S},
    "g11_sleep_outside": {"pkg/s.py": _S.replace(
        "        with self._lock:\n            time.sleep(0.5)",
        "        with self._lock:\n            pass\n"
        "        time.sleep(0.5)")},
    "g11_uncontended": {"pkg/s.py": _dedent("""
        import threading
        import time

        class Sched:
            def __init__(self):
                self._lock = threading.Lock()

            def tick(self):
                with self._lock:
                    time.sleep(0.5)
    """)},
    "g11_timeout_zero": {"pkg/s.py": _S.replace(
        "            time.sleep(0.5)",
        "            self.fut.result(timeout=0)")},
    "g11_condition_wait": {"pkg/s.py": _dedent("""
        import threading

        class Q:
            def __init__(self):
                self._cond = threading.Condition()
                self._thread = threading.Thread(target=self._loop)

            def _loop(self):
                with self._cond:
                    pass

            def pop(self):
                with self._cond:
                    self._cond.wait(timeout=0.05)
    """)},
    "g11_transitive": {"pkg/s.py": _S.replace(
        "            time.sleep(0.5)", "            self._flush()")
        + "\n    def _flush(self):\n        time.sleep(0.5)\n"},
    "g11_suppressed_source": {"pkg/s.py": _S.replace(
        "            time.sleep(0.5)",
        "            # graftlint: disable=G11 bounded 1ms debounce\n"
        "            time.sleep(0.5)")},
}

#: the blessed idioms: fixtures on which every rule stays quiet
QUIET_FIXTURES = {
    "g05_out_of_scope", "g05_reraise", "g05_suppressed",
    "g05_trailing_suppressed", "g05_typed", "g06_chokepoint",
    "g06_dynamic_fault", "g06_ifexp", "g06_labeled_fstring",
    "g06_module_constant", "g06_registered_fault", "g07_decoder_exempt",
    "g07_metadata", "g07_non_cache", "g07_ops_exempt", "g08_enter_context",
    "g08_every_known_phase", "g08_with", "g09_guarded", "g09_init_exempt",
    "g09_plain_rebind", "g09_single_thread", "g09_suppressed",
    "g10_consistent", "g10_rlock", "g11_condition_wait",
    "g11_sleep_outside", "g11_suppressed_source", "g11_timeout_zero",
    "g11_uncontended",
}

_SHARED_RULES = {"G00", "G05", "G06", "G07", "G08"}


def _keys(findings, rules=None):
    return sorted((f.rule, f.line, f.col) for f in findings
                  if rules is None or f.rule in rules)


@pytest.mark.parametrize("case", sorted(FILE_FIXTURES) + sorted(
    THREAD_FIXTURES))
def test_fixture_findings_match_reference(case):
    """The reference's fixture for G00 or G05-G11 gives the same findings
    (rule, line, column) through the port's linter as through the
    reference's, and fires unless it is a blessed idiom."""
    if case in FILE_FIXTURES:
        path, src = FILE_FIXTURES[case]
        src = _dedent(src)
        ref = _keys(ref_lint_source(path, src, ref_default_rules()),
                    _SHARED_RULES)
        got = _keys(lint_source(path, src, default_rules()), _SHARED_RULES)
    else:
        files = {p: _dedent(s) for p, s in THREAD_FIXTURES[case].items()}
        ref = _keys(ref_thread_findings(files))
        got = _keys(collect_thread_findings(files))
    assert got == ref
    assert bool(got) == (case not in QUIET_FIXTURES), got


# ---------------------------------------------------------------------------
# (b) G01 / G02 read for PyTorch
# ---------------------------------------------------------------------------

_ENGINE_HEAD = """
    import numpy as np
    import torch
    from ..models import decoder as dmod
    from . import strict

    def pipeline(self, batches):
        def launch(batch):
            ids = self._tensor(batch.token_ids, torch.int64)
            logits = dmod.prefill(ids)
            top = logits.argmax(-1)
            {body}
            return top

        def consume(batch, out):
            return out
        return launch, consume
"""

#: (body line inside ``launch``, rule it raises or None)
LAUNCH_CASES = {
    "item": ("n = top.item()", "G01"),
    "tolist": ("rows = top.tolist()", "G01"),
    "cpu": ("host = top.cpu()", "G01"),
    "numpy": ("host = top.numpy()", "G01"),
    "to_cpu": ('host = top.to("cpu")', "G01"),
    "to_device_cpu": ('host = top.to(device="cpu")', "G01"),
    "cuda_synchronize": ("torch.cuda.synchronize()", "G01"),
    "stream_synchronize": ("torch.cuda.current_stream().synchronize()",
                           "G01"),
    "int_on_tensor": ("n = int(logits.sum())", "G01"),
    "float_on_tensor": ("x = float(top[0])", "G01"),
    "bool_on_tensor": ("b = bool(top.any())", "G01"),
    "np_asarray_on_tensor": ("host = np.asarray(top)", "G01"),
    "np_array_on_tensor": ("host = np.array(logits)", "G01"),
    "if_on_tensor": ("if top.any(): pass", "G02"),
    "while_on_tensor": ("while (top > 0).all(): top = top - 1", "G02"),
    "assert_on_tensor": ("assert (ids >= 0).all()", "G02"),
    "ifexp_on_tensor": ("k = 1 if logits.max() > 0 else 0", "G02"),
    "not_on_tensor": ("if not top.any(): pass", "G02"),
    "numpy_value": ("n = int((batch.indices >= 0).sum())", None),
    "numpy_tolist": ("rows = batch.indices.tolist()", None),
    "metadata": ("n = int(top.shape[0]) + top.numel() + top.size(0)", None),
    "host_if": ("if batch.bucket_len > 8: pass", None),
    "is_none": ("if logits is not None: pass", None),
    "sanctioned_fetch": ("with strict.sanctioned_fetch():\n"
                         "                rows = top.tolist()\n"
                         "                if top.any(): pass", None),
}


def _launch_source(body):
    return _dedent(_ENGINE_HEAD).replace("{body}", body)


@pytest.mark.parametrize("case", sorted(LAUNCH_CASES))
def test_launch_region_syncs(case):
    """Inside a ``launch`` closure: tensor syncs (G01) and control flow on
    a tensor (G02) fire; numpy values, metadata, host decisions and a
    ``strict.sanctioned_fetch()`` block do not."""
    body, rule = LAUNCH_CASES[case]
    findings = lint_source("runtime/engine.py", _launch_source(body),
                           default_rules())
    assert [f.rule for f in findings] == ([rule] if rule else [])
    if rule:
        assert "launch pipeline closure" in findings[0].message


def test_consume_closure_is_sanctioned():
    """``consume`` is where fetches belong: the syncs that fire in
    ``launch`` are quiet there."""
    src = _dedent("""
        import numpy as np
        import torch

        def pipeline(engine):
            def consume(batch, out):
                t = torch.as_tensor(out)
                if t.any():
                    pass
                return t.tolist(), t.cpu(), int(t.sum()), np.asarray(t)
            return consume
    """)
    assert lint_source("runtime/engine.py", src, default_rules()) == []


def _chain(hops):
    """A launch closure calling h1 -> ... -> h<hops>, the last of which
    calls .cpu() on its (seeded) tensor parameter."""
    helpers = [f"def h{hops}(x):\n    return x.cpu()\n"]
    for i in range(hops - 1, 0, -1):
        helpers.append(f"def h{i}(x):\n    return h{i + 1}(x)\n")
    return ("import torch\n\n" + "\n".join(helpers)
            + "\ndef pipeline(engine):\n"
              "    def launch(batch):\n"
              "        x = torch.ones(4)\n"
              "        return h1(x)\n"
              "    return launch\n")


def test_helper_reached_from_launch_is_flagged_with_root_and_depth():
    src = _chain(2)
    findings = lint_source("runtime/engine.py", src, default_rules())
    assert [f.rule for f in findings] == ["G01"]
    assert "reachable from launch closure 'pipeline.launch'" \
        in findings[0].message
    assert "2 call hops" in findings[0].message
    # the per-function walk (no call graph) does not see it
    assert lint_source("runtime/engine.py", src, default_rules(),
                       interprocedural=False) == []


def test_helper_past_the_depth_bound_is_not_reached():
    src = _chain(INTERPROCEDURAL_DEPTH + 1)
    assert lint_source("runtime/engine.py", src, default_rules()) == []
    src = _chain(INTERPROCEDURAL_DEPTH)
    assert [f.rule for f in lint_source("runtime/engine.py", src,
                                        default_rules())] == ["G01"]


def test_host_helper_params_are_not_tensors():
    """A reached helper treats only the parameters that receive tensors
    at its device call sites as tensors: a host count does not trip
    G02."""
    src = _dedent("""
        import torch

        def helper(x, n):
            if n > 0:
                x = x * 2
            return x

        def pipeline(engine):
            def launch(batch):
                return helper(torch.ones(4), 3)
            return launch
    """)
    assert lint_source("runtime/engine.py", src, default_rules()) == []


def test_launch_outside_a_hot_module_is_no_region():
    src = _launch_source("rows = top.tolist()")
    assert lint_source("stats/bootstrap.py", src, default_rules()) == []


# ---------------------------------------------------------------------------
# (c) G03 / G04 have no PyTorch meaning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule", ["G03", "G04"])
def test_jax_only_rules_explain_why_they_do_not_run(rule, capsys):
    assert lint_cli.main(["--explain", rule]) == 0
    out = capsys.readouterr().out
    assert out.startswith(rule) and "not run on PyTorch" in out
    assert rule not in {r.rule for r in default_rules()}


def test_key_reuse_fixture_raises_nothing():
    """tests/test_lint.py's G03 and G04 fixtures fire in the reference and
    raise nothing here."""
    src = _dedent("""
        import jax

        def init(hidden):
            key = jax.random.PRNGKey(0)
            a = jax.random.normal(key, (hidden,))
            b = jax.random.normal(key, (hidden,))
            return a, b

        @jax.jit
        def prefill(x, cache_len, buckets=[]):
            return x[:cache_len]
    """)
    assert {f.rule for f in ref_lint_source("m.py", src,
                                            ref_default_rules())} \
        == {"G03", "G04"}
    assert lint_source("m.py", src, default_rules()) == []


# ---------------------------------------------------------------------------
# (d) the baseline ratchet
# ---------------------------------------------------------------------------

def _swallow_findings(pad=0):
    return lint_source("runtime/thing.py", "\n" * pad + _dedent(_SWALLOW),
                       default_rules())


def test_baseline_ratchet_and_stale_entry(tmp_path):
    findings = _swallow_findings()
    path = str(tmp_path / "baseline.json")
    save_baseline(findings, path, {findings[0].fingerprint: "keep-alive"})
    entries = load_baseline(path)
    assert entries[0]["rationale"] == "keep-alive"
    # line drift still matches; fixed code leaves a stale entry
    assert apply_baseline(_swallow_findings(pad=7), entries) == ([], [], 1)
    new, stale, matched = apply_baseline([], load_baseline(path))
    assert (new, matched, len(stale)) == ([], 0, 1)


def test_baseline_rot_check(tmp_path):
    d = tmp_path / "runtime"
    d.mkdir()
    entries = [{"rule": "G05", "path": "runtime/x.py",
                "code": "except Exception:", "rationale": "x"}]
    assert rotten_entries(entries, str(tmp_path)) == entries  # no file
    (d / "x.py").write_text("def f():\n    return g()\n")
    assert rotten_entries(entries, str(tmp_path)) == entries  # gone
    (d / "x.py").write_text("\n" * 9 + _dedent(_SWALLOW))
    assert rotten_entries(entries, str(tmp_path)) == []       # drifted


def test_cli_gate_fails_on_new_and_stale(tmp_path):
    bad = tmp_path / "runtime"
    bad.mkdir()
    (bad / "x.py").write_text(_dedent(_SWALLOW))
    baseline = str(tmp_path / "b.json")
    assert lint_cli.main([str(bad), "--baseline", baseline]) == 1
    assert lint_cli.main([str(bad), "--baseline", baseline,
                          "--write-baseline"]) == 0
    assert lint_cli.main([str(bad), "--baseline", baseline]) == 0
    (bad / "x.py").write_text("def f():\n    return g()\n")
    assert lint_cli.main([str(bad), "--baseline", baseline]) == 1


# ---------------------------------------------------------------------------
# (e) lint contracts: the port's tables and calibration rule have teeth
# ---------------------------------------------------------------------------

def _write_tree(root, files):
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(_dedent(text))


_PORT_README = """
    # Project

    ### Telemetry counters

    | Counter | Meaning |
    |---|---|
    | `ghost_counter` | the JAX package's table, not the port's |

    ## PyTorch/CUDA port (`{pkg}/`)

    ```bash
    # a shell comment is not a heading
    ```

    ### Telemetry counters (port)

    | Counter | Meaning |
    |---|---|
    | `real_counter` | documented and recorded |
""".replace("{pkg}", PKG_NAME)


def test_counter_missing_from_the_port_table_drifts(tmp_path, capsys):
    _write_tree(tmp_path, {
        "README.md": _PORT_README,
        f"{PKG_NAME}/mod.py": """
            from .utils.telemetry import record_counter

            def f():
                record_counter("real_counter")
                record_counter("ghost_counter")
        """,
    })
    assert contracts_main(["--root", str(tmp_path),
                           "--only", "counter-table"]) == 1
    out = capsys.readouterr().out
    # the JAX package's table above the port section does not count
    assert "counter 'ghost_counter' is recorded" in out
    assert "real_counter" not in out


def test_port_table_matching_the_code_is_clean(tmp_path):
    _write_tree(tmp_path, {
        "README.md": _PORT_README,
        f"{PKG_NAME}/mod.py": """
            from .utils.telemetry import record_counter

            def f():
                record_counter("real_counter")
        """,
    })
    assert contracts_main(["--root", str(tmp_path),
                           "--only", "counter-table"]) == 0


@pytest.mark.parametrize("line,drifts", [
    ("X = 1.0  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 "
     "80GB HBM3, 700.00 W", False),
    ("X = 1.0  # prior: one card, no run to measure", False),
    ("X = 1.0  # anchor: BENCH_r05", True),
    ("X = 1.0  # anchor: scripts/calibrate_plan_torch.py", True),
    ("X = 1 << 28", True),
    ("X = (1, 2)  # a menu, not a coefficient", False),
    ("X = 1.0  # prior: the v5e figure", True),
])
def test_calibration_rule(tmp_path, line, drifts):
    _write_tree(tmp_path, {f"{PKG_NAME}/runtime/plan.py": line + "\n",
                           f"{PKG_NAME}/runtime/plan_search.py": ""})
    rc = contracts_main(["--root", str(tmp_path), "--only", "calibration"])
    assert rc == (1 if drifts else 0)


@pytest.mark.parametrize("kind", ["record-blocks", "child-flags"])
def test_benchmark_checks_wait_for_the_benchmark(kind, capsys):
    assert contracts_main(["--only", kind]) == 0
    assert contracts_main(["--explain", kind]) == 0
    out = capsys.readouterr().out
    assert out.count("waits for the port's benchmark PR") == 2


# ---------------------------------------------------------------------------
# (f) the repo gate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def repo_findings():
    return lint_paths(default_paths())


@pytest.fixture(scope="module")
def repo_model():
    return model_from_paths(default_paths())


def test_repo_has_no_new_finding(repo_findings):
    entries = load_baseline(lint_cli.default_baseline_path())
    new, stale, _ = apply_baseline(repo_findings, entries)
    assert (new, stale) == ([], []), [f.format() for f in new]
    assert rotten_entries(entries, REPO_ROOT) == []


def test_baseline_is_small_justified_and_free_of_races():
    entries = load_baseline(lint_cli.default_baseline_path())
    assert len(entries) <= 10
    for e in entries:
        assert e["rationale"].strip() and "TODO" not in e["rationale"], e
        assert e["rule"] not in ("G09", "G10", "G11"), e


def test_repo_has_no_concurrency_finding(repo_findings):
    assert [f.format() for f in repo_findings
            if f.rule in ("G09", "G10", "G11")] == []


def test_lock_graph_is_cycle_free_with_the_pool_lock_outer(repo_model):
    assert repo_model.lock_cycles() == []
    pool = PKG_NAME + ".serve.pool:EnginePool._lock"
    counters = PKG_NAME + ".utils.telemetry:_COUNTERS_LOCK"
    assert (pool, counters) in repo_model.lock_edges
    assert not [e for e in repo_model.lock_edges if e[1] == pool]


def test_a_checkout_under_a_build_directory_is_linted(tmp_path):
    """The excluded parts are matched below the scanned directory: a
    checkout unpacked under a ``build/`` directory is linted whole, and
    its own ``build/`` is skipped."""
    tree = tmp_path / "build" / "checkout"
    _write_tree(tree, {"runtime/x.py": _SWALLOW,
                       "build/y.py": _SWALLOW,
                       "tests/test_z.py": _SWALLOW})
    files = [os.path.relpath(f, tree)
             for f in lint_cli.iter_python_files([str(tree)])]
    assert files == [os.path.join("runtime", "x.py")]
    found = lint_paths([str(tree)], root=str(tree))
    assert [(f.rule, f.path) for f in found] == [("G05", "runtime/x.py")]


def test_default_paths_cover_the_port_and_the_smoke():
    paths = default_paths()
    assert paths == [os.path.join(REPO_ROOT, PKG_NAME),
                     os.path.join(REPO_ROOT, "chip_smoke.py")]
    scanned = [f.replace(os.sep, "/")
               for f in lint_cli.iter_python_files(paths)]
    for mod in ("/runtime/engine.py", "/serve/pool.py", "/lint/cli.py",
                "/obs/tracer.py", "chip_smoke.py"):
        assert any(f.endswith(mod) for f in scanned), mod
    assert not any("/build/" in f for f in scanned)


def _run(*argv):
    return subprocess.run([sys.executable, "-m", PKG_NAME, *argv],
                          capture_output=True, text=True, cwd=REPO_ROOT,
                          timeout=300)


def test_lint_command_exits_zero_without_cuda_or_jax():
    """The gate as users run it; the linter imports nothing of JAX and
    creates no CUDA context."""
    code = ("import runpy, sys, torch\n"
            "sys.argv = ['x', 'lint', '--format', 'json']\n"
            "try:\n"
            f"    runpy.run_module({PKG_NAME!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'llm_interpretation_replication_tpu'))\n"
            "print(json.dumps([rc, bad, torch.cuda.is_initialized()]))\n")
    proc = subprocess.run([sys.executable, "-c", "import json\n" + code],
                          capture_output=True, text=True, cwd=REPO_ROOT,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    *report, last = proc.stdout.strip().splitlines()
    assert json.loads(last) == [0, [], False]
    doc = json.loads("\n".join(report))
    assert doc["findings"] == [] and doc["stale_baseline"] == []


def test_contracts_command_exits_zero():
    proc = _run("lint", "contracts")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "contracts clean" in proc.stdout


# ---------------------------------------------------------------------------
# The serve-pool races the linter found (G09), pinned
# ---------------------------------------------------------------------------

class _BrokenUpLink:
    """A ``_SliceLink`` stand-in whose up line breaks when released."""

    idle_s = 3600.0

    def __init__(self):
        self.release = threading.Event()
        self.error = ConnectionError("the slice's line broke")
        self.sent = []

    def recv_up(self):
        assert self.release.wait(10)
        raise self.error

    def send_down(self, msg):
        self.sent.append(msg)


class _WatchedLock:
    """A lock that tells when its ``reader`` thread first gets to it:
    when the reader finds it held (it then waits) or once the reader has
    held and released it."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reader = None
        self.reached = threading.Event()

    def __enter__(self):
        mine = threading.current_thread() is self.reader
        if not self._lock.acquire(blocking=False):
            if mine:
                self.reached.set()
            self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        if threading.current_thread() is self.reader:
            self.reached.set()


class _BreakBetween:
    """``SliceReplica._seq`` stand-in: taking a sequence number breaks the
    line and returns once the reader thread has got to the lock — so a
    dispatch that took its number is ordered against the reader's drain."""

    def __init__(self, link, lock):
        self.link, self.lock = link, lock

    def __iter__(self):
        return self

    def __next__(self):
        self.link.release.set()
        assert self.lock.reached.wait(10)
        return 0


class TestConcurrencyRegressions:
    """Functional twins of the two G09 findings on ``serve/pool.py``."""

    def test_dispatch_racing_a_broken_line_fails_with_its_error(self):
        """G09 serve/pool.py ``SliceReplica.state`` (``_read`` and
        ``shutdown`` wrote it outside ``self._lock``): ``dispatch``
        checked ``state``/``error`` outside the lock the reader drains
        under, so a request that passed the check before the line broke
        and registered after the drain was never answered.  Now the check
        and the registration are one step under that lock: the request
        fails with the line's error."""
        from llm_interpretation_replication_tpu_torch.serve import pool
        from llm_interpretation_replication_tpu_torch.serve.request import (
            SchedulerClosed,
        )

        link = _BrokenUpLink()
        replica = pool.SliceReplica("r1", "m", link, devices=(1,),
                                    placement="sliced")
        watched = _WatchedLock()
        watched.reader = replica._reader
        replica._lock = watched
        replica._seq = _BreakBetween(link, watched)
        future = replica.dispatch(types.SimpleNamespace(request="q"))
        assert future.exception(timeout=5) is link.error
        replica._reader.join(10)
        assert not replica._reader.is_alive()
        assert replica.state == "closed" and replica.error is link.error
        with pytest.raises(SchedulerClosed):
            replica.dispatch(types.SimpleNamespace(request="q2"))

    def test_slice_server_keeps_the_first_error(self):
        """G09 serve/pool.py ``_SliceServer.error`` (written by the serve
        and answer threads, never under a lock): the serve thread's plain
        assignment overwrote the error the answer thread had recorded.
        Now both keep the first error under ``self._lock``: ``join``
        raises the error that broke the line."""
        from llm_interpretation_replication_tpu_torch.serve import pool

        class Link:
            idle_s = 0.0
            server = None
            go = threading.Event()
            up_error = ConnectionError("the up line broke first")
            down_error = ConnectionError("the down line broke after")

            def send_up(self, msg):
                raise self.up_error

            def recv_down(self):
                assert self.go.wait(10)
                self.server._threads[1].join(10)  # the answer thread ended
                raise self.down_error

        closed = []
        replica = types.SimpleNamespace(
            rid="r1", scheduler=types.SimpleNamespace(
                close=lambda drain: closed.append(drain)))
        link = Link()
        server = pool._SliceServer(replica, link)
        link.server = server
        link.go.set()
        for t in server._threads:
            t.join(10)
            assert not t.is_alive()
        with pytest.raises(ConnectionError) as info:
            server.join()
        assert info.value is link.up_error
        assert closed == [True]
