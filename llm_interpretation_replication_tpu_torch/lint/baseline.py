"""Baseline (grandfather) file handling for the port's linter (a copy of
the reference's ``lint/baseline.py``).

The baseline is the ratchet that lets the linter gate CI from day one: the
findings that existed when the gate landed are recorded in
``lint_baseline_torch.json`` WITH a written rationale each, and the tier-1 test
fails on anything not in that list.  The file only ever shrinks — fixing a
grandfathered finding turns its entry stale, and stale entries are reported
so they get deleted rather than quietly shielding a future regression of
the same shape.

Matching is by ``(rule, path, normalized code line)`` — the same
fingerprint :class:`..lint.report.Finding` exposes — so entries survive
unrelated edits that shift line numbers, but NOT edits to the flagged line
itself (changing the line means re-justifying the exemption).  Entries
match at most once: two identical violations need two entries.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

from .report import Finding, normalize_code

BASELINE_VERSION = 1


def load_baseline(path: str) -> List[Dict]:
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if isinstance(data, dict):
        entries = data.get("findings", [])
    else:  # bare list form
        entries = data
    for e in entries:
        e.setdefault("rationale", "")
    return entries


def save_baseline(findings: Sequence[Finding], path: str,
                  rationales: Dict[Tuple[str, str, str], str] = None) -> None:
    """Write ``findings`` as a fresh baseline.  New entries get a TODO
    rationale — the repo convention (tests/test_torch_lint.py enforces it) is
    that every checked-in entry carries a real one."""
    rationales = rationales or {}
    entries = [{
        "rule": f.rule,
        "path": f.path,
        "line": f.line,
        "code": normalize_code(f.code),
        "rationale": rationales.get(f.fingerprint,
                                    "TODO: justify this exemption"),
    } for f in findings]
    payload = {"version": BASELINE_VERSION, "findings": entries}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")


def rotten_entries(entries: Sequence[Dict], root: str) -> List[Dict]:
    """Baseline entries whose fingerprint no longer matches ANY line of
    the file they point at (or whose file is gone) — baseline rot.

    ``apply_baseline`` only surfaces stale entries for files the current
    run actually linted; a subset run (``--diff``, explicit paths) would
    let an entry for a deleted/rewritten file linger forever, silently
    re-shielding the next violation with the same fingerprint.  This
    check is scope-independent: the entry's own file is re-read from
    disk, so rot fails the gate on every run regardless of target set."""
    rotten: List[Dict] = []
    for e in entries:
        rel = e.get("path", "")
        code = normalize_code(e.get("code", ""))
        try:
            with open(os.path.join(root, rel), encoding="utf-8") as f:
                lines = f.read().splitlines()
        except OSError:
            rotten.append(e)
            continue
        if not code or not any(normalize_code(line) == code
                               for line in lines):
            rotten.append(e)
    return rotten


def apply_baseline(findings: Sequence[Finding], entries: Sequence[Dict]
                   ) -> Tuple[List[Finding], List[Dict], int]:
    """Split ``findings`` against the baseline.

    Returns ``(new_findings, stale_entries, matched_count)``; each entry
    absorbs at most one finding (multiset semantics)."""
    budget: Dict[Tuple[str, str, str], List[Dict]] = {}
    for e in entries:
        key = (e.get("rule", ""), e.get("path", ""),
               normalize_code(e.get("code", "")))
        budget.setdefault(key, []).append(e)
    new: List[Finding] = []
    matched = 0
    for f in findings:
        bucket = budget.get(f.fingerprint)
        if bucket:
            bucket.pop()
            matched += 1
        else:
            new.append(f)
    stale = [e for bucket in budget.values() for e in bucket]
    return new, stale, matched
