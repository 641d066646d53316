"""The port's linter: the reference's ``lint/`` package (graftlint) read
for PyTorch and pointed at this package.

The silent killers of a CUDA serving stack are not crashes — they are
unintended device->host syncs (one ``.item()`` or one ``if tensor:``
waits for every kernel queued before it and serializes the engine's
launch/consume pipeline) and host threads racing on shared state.  This
package makes reintroducing them a TEST FAILURE instead of a perf or
concurrency mystery.  It reads sources as ASTs: it imports nothing of the
card's path and creates no CUDA context.

Layout (the reference's modules, same names):

- :mod:`.visitor` — the AST passes: a module-level call graph that
  propagates device-region membership from the engine's ``launch``
  closures into the helpers they reach (bounded depth, import-alias
  aware), tensor-value inference, then the rule-dispatching walk.
- :mod:`.rules` — G01 (host-sync), G02 (control flow on a tensor: a
  hidden ``Tensor.__bool__`` sync), G05 (broad except before fault
  classification), G06 (telemetry naming discipline), G07 (KV-cache
  scale awareness), G08 (tracer span hygiene); G03 (PRNG key reuse) and
  G04 (jit boundary) keep their catalogue rows but do not run — they
  have no PyTorch meaning.
- :mod:`.contracts` — layer 2, ``lint contracts``: code vs the README
  port section's counter and phase tables, the pyproject marker
  registry, and the plan model's calibration provenance.
- :mod:`.threads` — layer 3, the whole-tree concurrency analysis (G09
  guarded-by, G10 lock-order, G11 blocking-under-lock).
- :mod:`.report` — findings, fingerprints, suppressions, formatting.
- :mod:`.baseline` — the grandfathered-findings ratchet
  (``lint_baseline_torch.json``), including the rot check.
- :mod:`.cli` — ``python -m llm_interpretation_replication_tpu_torch
  lint`` (``--diff`` for changed-files runs);
  ``tests/test_torch_lint.py`` runs it inside tier-1.

The runtime complement lives in :mod:`..runtime.strict`: ``--strict``
arms ``torch.cuda.set_sync_debug_mode`` around the scoring pipeline, so
the contract G01/G02 enforce statically is enforced on the card too.
"""

from .baseline import (apply_baseline, load_baseline, rotten_entries,
                       save_baseline)
from .cli import changed_files, default_paths, lint_paths, main
from .contracts import check_contracts
from .report import Finding, format_report
from .rules import RULES, default_rules
from .threads import (ThreadModel, build_model, collect_thread_findings,
                      model_from_paths)
from .visitor import lint_source

__all__ = [
    "Finding",
    "RULES",
    "ThreadModel",
    "build_model",
    "collect_thread_findings",
    "model_from_paths",
    "apply_baseline",
    "changed_files",
    "check_contracts",
    "default_paths",
    "default_rules",
    "format_report",
    "lint_paths",
    "lint_source",
    "load_baseline",
    "main",
    "rotten_entries",
    "save_baseline",
]
