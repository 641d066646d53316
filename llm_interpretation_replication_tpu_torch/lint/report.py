"""Findings, suppression comments, and output formatting for the port's
linter (a copy of the reference's ``lint/report.py``).

A :class:`Finding` is one rule violation anchored to a source line.  Its
identity for baseline matching is the :meth:`Finding.fingerprint` —
``(rule, path, normalized code line)`` — NOT the line number: grandfathered
findings must survive unrelated edits above them, and a baseline keyed on
line numbers would go stale on every refactor.  The line number is kept for
display and as a tiebreaker when the same code text appears twice.

Inline suppressions use the reference-linter idiom::

    except Exception as err:  # graftlint: disable=G05 sweep must outlive one bad row

The comment may sit on the flagged line or the line directly above it, and
carries a free-text reason after the rule list (comma-separated rule ids).
A suppression WITHOUT a reason still works — the linter is a gate, not a
bureaucracy — but the repo convention is to
always say why (README, the port section's "Static analysis (lint)").
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

_DISABLE_RE = re.compile(r"#\s*graftlint:\s*disable=([A-Z0-9,\s]+?)(?:\s+(.*))?$")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str           # "G00".."G11"
    path: str           # repo-relative posix path
    line: int           # 1-indexed source line
    col: int
    message: str        # human explanation of this instance
    code: str           # stripped source line the finding anchors to

    @property
    def fingerprint(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, normalize_code(self.code))

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def to_json(self) -> Dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "col": self.col, "message": self.message, "code": self.code,
        }


def normalize_code(code: str) -> str:
    """Whitespace-insensitive form of a source line (baseline matching)."""
    return " ".join(code.split())


def parse_suppressions(lines: Sequence[str]) -> Dict[int, List[str]]:
    """{1-indexed line: [rule ids]} for every ``graftlint: disable=`` comment.

    Both comment styles work, each scoped to exactly ONE code line — a
    standalone comment covers the line below it, a trailing comment covers
    its own line (and must NOT bleed onto the next, or a same-line
    suppression would silently exempt an unrelated following statement)::

        # graftlint: disable=G05 reason
        except Exception:          # <- suppressed

        except Exception:  # graftlint: disable=G05 reason   <- suppressed
    """
    out: Dict[int, List[str]] = {}
    for i, text in enumerate(lines, start=1):
        m = _DISABLE_RE.search(text)
        if not m:
            continue
        rules = [r.strip() for r in m.group(1).split(",") if r.strip()]
        standalone = text[: m.start()].strip() in ("", "#")
        target = i + 1 if standalone else i
        out.setdefault(target, []).extend(rules)
    return out


def suppressed(finding: Finding, suppressions: Dict[int, List[str]]) -> bool:
    return finding.rule in suppressions.get(finding.line, ())


def format_report(findings: Sequence[Finding],
                  stale: Sequence[Dict] = (),
                  baselined: int = 0,
                  fmt: str = "text",
                  rot: Sequence[Dict] = ()) -> str:
    """Render the lint result.  ``findings`` are the NEW (non-baselined)
    violations; ``stale`` are baseline entries that no longer match any
    finding in this run's target set (fixed code whose grandfather clause
    should be deleted); ``rot`` are entries whose fingerprint matches no
    line of their own file on disk (scope-independent baseline rot)."""
    if fmt == "json":
        return json.dumps({
            "findings": [f.to_json() for f in findings],
            "stale_baseline": list(stale),
            "rotten_baseline": list(rot),
            "baselined": baselined,
        }, indent=2)
    lines: List[str] = [f.format() for f in findings]
    for entry in stale:
        lines.append(
            f"# stale baseline entry ({entry.get('rule')} "
            f"{entry.get('path')}): no longer matches — delete it from the "
            f"baseline ({normalize_code(entry.get('code', ''))!r})")
    for entry in rot:
        lines.append(
            f"# rotten baseline entry ({entry.get('rule')} "
            f"{entry.get('path')}): fingerprint matches no line of that "
            f"file on disk — the exempted code is gone; delete the entry "
            f"({normalize_code(entry.get('code', ''))!r})")
    summary = (f"{len(findings)} new finding(s)"
               + (f", {baselined} baselined" if baselined else "")
               + (f", {len(stale)} stale baseline entr"
                  f"{'y' if len(stale) == 1 else 'ies'}" if stale else "")
               + (f", {len(rot)} rotten baseline entr"
                  f"{'y' if len(rot) == 1 else 'ies'}" if rot else ""))
    lines.append(summary if (findings or stale or rot or baselined)
                 else "clean: no findings")
    return "\n".join(lines)


def sort_findings(findings: List[Finding]) -> List[Finding]:
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))
