"""``python -m llm_interpretation_replication_tpu_torch lint`` — the
port's gate (the reference's ``lint/cli.py`` over the port).

Collects the default target set (the port package plus the repo-root
``chip_smoke.py``, the port's counterpart of the reference's
``bench.py``), runs every rule, subtracts the checked-in
``lint_baseline_torch.json``, and exits non-zero on any new finding.
``tests/test_torch_lint.py`` runs exactly this entry point inside tier-1,
and ``chip_smoke.py``'s stats phase runs it on the card's host.  It reads
sources as ASTs: it imports nothing of the card's path and creates no
CUDA context.

Usage::

    python -m llm_interpretation_replication_tpu_torch lint
    python -m llm_interpretation_replication_tpu_torch lint --format json
    python -m llm_interpretation_replication_tpu_torch lint path/to/file.py
    python -m llm_interpretation_replication_tpu_torch lint --diff       # changed files only
    python -m llm_interpretation_replication_tpu_torch lint --explain G02
    python -m llm_interpretation_replication_tpu_torch lint --write-baseline  # refresh
    python -m llm_interpretation_replication_tpu_torch lint contracts    # cross-artifact layer
"""

from __future__ import annotations

import argparse
import ast
import os
import sys
from typing import List, Optional, Sequence, Set

from .baseline import (apply_baseline, load_baseline, rotten_entries,
                       save_baseline)
from .report import Finding, format_report, sort_findings
from .rules import RULES, default_rules
from .visitor import lint_source

#: directories never linted (vendored/caches, the kernels' build
#: outputs); tests are exempt because fixtures deliberately contain
#: violations.
EXCLUDE_PARTS = ("/.git/", "/__pycache__/", "/.jax_cache/", "/tests/",
                 "/build/")

PKG_NAME = "llm_interpretation_replication_tpu_torch"


def repo_root() -> str:
    """The directory holding the package (and chip_smoke.py / the
    baseline)."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


def default_paths() -> List[str]:
    root = repo_root()
    paths = [os.path.join(root, PKG_NAME)]
    smoke = os.path.join(root, "chip_smoke.py")
    if os.path.exists(smoke):
        paths.append(smoke)
    return paths


def default_baseline_path() -> str:
    return os.path.join(repo_root(), "lint_baseline_torch.json")


def changed_files(root: Optional[str] = None) -> Optional[List[str]]:
    """Repo-relative posix paths changed vs git HEAD (staged, unstaged,
    and untracked) — the ``--diff`` target set for cheap CI.  Returns
    ``None`` when git is unavailable or ``root`` is not a work tree, so
    callers can fall back to the full scan rather than silently passing
    an empty diff."""
    import subprocess

    root = os.path.abspath(root or repo_root())
    out: List[str] = []
    for cmd in (["git", "diff", "--name-only", "HEAD"],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            proc = subprocess.run(cmd, cwd=root, capture_output=True,
                                  text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if proc.returncode != 0:
            return None
        out.extend(line.strip() for line in proc.stdout.splitlines()
                   if line.strip())
    return sorted(set(out))


def iter_python_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git")]
                for fname in sorted(filenames):
                    if fname.endswith(".py"):
                        full = os.path.join(dirpath, fname)
                        # matched below the scanned directory: a checkout
                        # that itself sits under a build/ or tests/
                        # directory is still linted
                        below = "/" + os.path.relpath(full, p).replace(
                            os.sep, "/")
                        if not any(part in below for part in EXCLUDE_PARTS):
                            out.append(full)
        elif p.endswith(".py"):
            out.append(p)
    return out


def lint_paths(paths: Sequence[str], root: Optional[str] = None,
               rules=None, threads: bool = True) -> List[Finding]:
    """Lint files/directories; paths in findings are relative to ``root``
    (default: the repo root) so baselines are machine-independent.

    Runs two layers: the per-file rules (G01, G02, G05-G08) and, unless
    ``threads=False``, the whole-tree concurrency layer (G09-G11) over
    exactly the files scanned.  A partial scan both misses cross-module
    findings AND can invent ones the full tree refutes (a caller that
    holds the lock may live in an unscanned file), which is why
    ``main()``'s ``--diff`` mode passes ``threads=False`` and instead
    runs :func:`thread_findings` over the full target set, filtering
    the report to the changed files."""
    root = os.path.abspath(root or repo_root())
    rules = rules if rules is not None else default_rules()
    findings: List[Finding] = []
    texts, trees = {}, {}
    for fname in iter_python_files(paths):
        try:
            with open(fname, encoding="utf-8") as f:
                text = f.read()
        except OSError as err:
            print(f"# lint: cannot read {fname}: {err}", file=sys.stderr)
            continue
        rel = os.path.relpath(os.path.abspath(fname), root)
        rel_posix = rel.replace(os.sep, "/")
        texts[rel_posix] = text
        try:
            # parsed once: the thread layer reuses the tree
            trees[rel_posix] = ast.parse(text)
        except SyntaxError:
            pass    # lint_source reports it as G00
        findings.extend(lint_source(rel_posix, text, rules,
                                    tree=trees.get(rel_posix)))
    if threads and texts:
        from .threads import collect_thread_findings

        findings.extend(collect_thread_findings(texts, trees))
    return sort_findings(findings)


def thread_findings(paths: Optional[Sequence[str]] = None,
                    root: Optional[str] = None) -> List[Finding]:
    """Concurrency findings (G09-G11) over the FULL target set (default:
    the repo gate's), independent of any ``--diff`` restriction — the
    thread model needs every module at once to resolve cross-module
    locks, thread roots, and entry-held callers."""
    root = os.path.abspath(root or repo_root())
    texts = {}
    for fname in iter_python_files(paths or default_paths()):
        try:
            with open(fname, encoding="utf-8") as f:
                text = f.read()
        except OSError:
            continue
        rel = os.path.relpath(os.path.abspath(fname), root)
        texts[rel.replace(os.sep, "/")] = text
    if not texts:
        return []
    from .threads import collect_thread_findings

    return sort_findings(collect_thread_findings(texts))


def main(argv: Optional[Sequence[str]] = None) -> int:
    if argv and argv[0] == "contracts":
        # layer 2: cross-artifact contract checking (`lint contracts`),
        # routed before argparse like the parent `lint` routing itself
        from .contracts import main as contracts_main

        return contracts_main(list(argv[1:]))
    parser = argparse.ArgumentParser(
        prog="llm_interpretation_replication_tpu_torch lint",
        description="PyTorch-aware static analysis (per-file rules G01, "
                    "G02, G05-G08 with interprocedural device regions, "
                    "plus the "
                    "whole-tree concurrency layer G09-G11: thread-model "
                    "inference, guarded-by checking, lock-order deadlock "
                    "detection) with a grandfathered-findings baseline; "
                    "`lint contracts` runs the cross-artifact layer")
    parser.add_argument("paths", nargs="*",
                        help="files/dirs to lint (default: the package + "
                             "chip_smoke.py)")
    parser.add_argument("--diff", action="store_true",
                        help="lint only files changed vs git HEAD "
                             "(staged+unstaged+untracked); the baseline "
                             "rot check still covers the whole file")
    parser.add_argument("--baseline", default=None,
                        help="baseline JSON (default: "
                             "lint_baseline_torch.json at the repo root; "
                             "missing file = empty)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="report every finding, grandfathered or not")
    parser.add_argument("--write-baseline", action="store_true",
                        help="write the current findings as the new "
                             "baseline (preserving rationales of entries "
                             "that still match) and exit 0")
    parser.add_argument("--format", choices=["text", "json"], default="text")
    parser.add_argument("--explain", metavar="RULE", default=None,
                        help="print a rule's description and exit")
    args = parser.parse_args(argv)

    if args.explain:
        rid = args.explain.upper()
        if rid == "ALL":
            for rule_id, (title, desc) in sorted(RULES.items()):
                print(f"{rule_id} [{title}] {desc}")
            return 0
        if rid not in RULES:
            print(f"unknown rule {args.explain!r}; known: "
                  f"{', '.join(sorted(RULES))}")
            return 2
        title, desc = RULES[rid]
        print(f"{rid} [{title}] {desc}")
        return 0

    if args.diff and args.write_baseline:
        # a baseline written from a changed-files subset would silently
        # drop every grandfathered entry for untouched files
        print("--write-baseline needs the full scan; drop --diff",
              file=sys.stderr)
        return 2

    paths = args.paths or default_paths()
    linted_rel: Optional[Set[str]] = None
    if args.diff:
        root = repo_root()
        changed = changed_files(root)
        if changed is None:
            print("# lint --diff: git unavailable; falling back to the "
                  "full scan", file=sys.stderr)
        else:
            changed_abs = {os.path.abspath(os.path.join(root, c))
                           for c in changed}
            paths = [f for f in iter_python_files(paths)
                     if os.path.abspath(f) in changed_abs]
            # stale accounting below is restricted to the files actually
            # linted — a --diff run must not flag every untouched file's
            # baseline entry as stale; rot (scope-independent) still runs
            linted_rel = {
                os.path.relpath(os.path.abspath(f), root).replace(
                    os.sep, "/")
                for f in paths}
    if linted_rel is None:
        findings = lint_paths(paths)
    else:
        # --diff: per-file rules over the changed files only, but the
        # thread model over the FULL target set (a subset scan would
        # both miss cross-module findings and invent ones the missing
        # callers refute) — reported for the changed files
        findings = sort_findings(
            lint_paths(paths, threads=False)
            + [f for f in thread_findings() if f.path in linted_rel])
    baseline_path = args.baseline or default_baseline_path()

    if args.write_baseline:
        old = load_baseline(baseline_path)
        rationales = {
            (e.get("rule", ""), e.get("path", ""),
             " ".join(e.get("code", "").split())): e.get("rationale", "")
            for e in old if e.get("rationale")}
        save_baseline(findings, baseline_path, rationales)
        print(f"wrote {len(findings)} finding(s) to {baseline_path}")
        return 0

    entries = [] if args.no_baseline else load_baseline(baseline_path)
    rot = rotten_entries(entries, repo_root())
    scoped = (entries if linted_rel is None
              else [e for e in entries if e.get("path") in linted_rel])
    new, stale, matched = apply_baseline(findings, scoped)
    # a rotten entry is usually also stale on a full run — report it once,
    # under the more specific diagnosis
    rot_ids = set(map(id, rot))
    stale = [e for e in stale if id(e) not in rot_ids]
    print(format_report(new, stale=stale, baselined=matched,
                        fmt=args.format, rot=rot))
    # stale/rotten entries fail the gate too: the baseline is a ratchet,
    # and a leftover entry for fixed code would silently re-shield the
    # next violation with the same fingerprint — delete it (or
    # --write-baseline)
    return 1 if (new or stale or rot) else 0


if __name__ == "__main__":
    raise SystemExit(main())
