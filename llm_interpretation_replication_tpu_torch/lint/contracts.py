"""``lint contracts``: cross-artifact drift checking (the linter's layer
2), the reference's ``lint/contracts.py`` pointed at the port.

Layer 1 (the G-rules) checks code against code-local conventions.  This
layer parses the codebase AND the docs/config as ONE system and fails on
drift between artifacts that describe each other — the conventions that,
before this checker, were each guarded by a hand-written source-pin test
that rotted one PR at a time:

- **counter-table** — telemetry counters recorded in the port's code
  (``record_counter`` and its chokepoint wrappers) vs the "Telemetry
  counters" table inside the README's ``## PyTorch/CUDA port`` section
  (the README's earlier table describes the JAX package).  A counter
  recorded but undocumented never shows up in anyone's dashboard
  runbook; a documented counter nothing records is a row readers will
  wait on forever (and, since the
  Prometheus exporter enumerates the telemetry registry generically,
  "documented but never recorded" is exactly "documented but never
  exported").
- **markers** — pytest markers used in ``tests/`` vs the
  ``[tool.pytest.ini_options] markers`` registry in pyproject.toml, both
  directions (an unregistered marker is a silent ``-m`` no-op under
  ``--strict-markers``; a registered-but-unused one is dead config).
- **phase-table** — the port's :data:`..obs.tracer.KNOWN_PHASES` vs the
  "Span / phase names" table in the same README section (G08 enforces
  code→table membership; this check keeps the two tables in lockstep).
- **calibration** — every pinned cost-model coefficient in the port's
  ``runtime/plan.py`` / ``runtime/plan_search.py`` must cite its
  provenance: ``# anchor: scripts/calibrate_plan_torch.py on NVIDIA
  <card>, <limit> W`` (measured by that script on that card) or ``#
  prior: <rationale>`` (a documented guess and its recalibration
  story), and no line of those files may name a TPU record or chip.
- **record-blocks** and **child-flags** read the reference's
  ``bench.py`` record and its full-study child; the port has no
  benchmark yet, so they do not run (``--only`` and ``--explain`` say
  so) and wait for the port's benchmark PR.

Everything here is static (regex + ``ast`` over sources): no package
import, no CUDA context — cheap enough to run before pytest in the tier-1
gate.  ``--root`` points the checker at another tree (the teeth tests
seed drift into temp copies).
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .cli import repo_root

PKG_NAME = "llm_interpretation_replication_tpu_torch"

#: the README section the port's tables live in
PORT_SECTION = "## PyTorch/CUDA port"

#: marks provided by pytest itself — never need registration.
_BUILTIN_MARKS = {"parametrize", "skip", "skipif", "xfail", "usefixtures",
                  "filterwarnings", "tryfirst", "trylast"}

#: registered marks that are legitimately unused by any test TODAY:
#: ``slow`` is the tier-1 gate's exclusion selector (``-m 'not slow'``
#: in ROADMAP's verify command) — the registration documents the gate
#: convention and must survive windows where nothing is marked slow.
_SELECTOR_MARKS = {"slow"}

# Only counter-kind names (record_counter + its chokepoint wrappers)
# are checked against the README counter table — sample rings and
# histograms are documented prose-side next to it.


class Drift:
    """One cross-artifact disagreement."""

    def __init__(self, kind: str, message: str, artifact: str):
        self.kind = kind          # check id, e.g. "counter-table"
        self.message = message
        self.artifact = artifact  # the artifact that needs the edit

    def format(self) -> str:
        return f"[{self.kind}] {self.message} (fix in: {self.artifact})"

    def to_json(self) -> Dict:
        return {"kind": self.kind, "message": self.message,
                "artifact": self.artifact}


# ---------------------------------------------------------------------------
# shared parsing helpers
# ---------------------------------------------------------------------------

def _read(path: str) -> Optional[str]:
    try:
        with open(path, encoding="utf-8") as f:
            return f.read()
    except OSError:
        return None


def _iter_package_files(root: str) -> List[str]:
    pkg = os.path.join(root, PKG_NAME)
    out = []
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".git")]
        for fname in sorted(filenames):
            if fname.endswith(".py"):
                out.append(os.path.join(dirpath, fname))
    smoke = os.path.join(root, "chip_smoke.py")
    if os.path.exists(smoke):
        out.append(smoke)
    return out


def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _port_lines(md: str) -> List[str]:
    """The README's lines from the port section's heading to the next
    level-2 heading, with fenced code blocks dropped (a ``# comment`` in
    a shell example is not a heading)."""
    out: List[str] = []
    inside = fenced = False
    for line in md.splitlines():
        if line.startswith("```"):
            fenced = not fenced
            continue
        if fenced:
            continue
        if line.startswith("## "):
            if inside:
                break
            inside = line.startswith(PORT_SECTION)
        if inside:
            out.append(line)
    return out


def _table_rows(md: str, heading: str) -> List[str]:
    """Backticked names from the FIRST column of the markdown table under
    ``heading`` inside the port's README section (rows until the next
    heading).  ``\\|`` inside backticks (the labeled-twin spellings) is
    unescaped after the column split."""
    names: List[str] = []
    in_section = False
    for line in _port_lines(md):
        if line.startswith("#") and heading in line:
            in_section = True
            continue
        if in_section and line.startswith("#"):
            break
        if not in_section or not line.startswith("|"):
            continue
        cell = line.replace("\\|", "\x00").split("|")[1]
        for name in re.findall(r"`([^`]+)`", cell.replace("\x00", "\\|")):
            names.append(name)
    return names


# ---------------------------------------------------------------------------
# check 1: telemetry counters vs README counter table
# ---------------------------------------------------------------------------

def _first_arg_literal_base(arg: ast.expr) -> List[str]:
    """Statically-resolvable base name(s) of a metric-name expression:
    the literal (or literal f-string prefix / both IfExp arms), stripped
    of the ``|k=v`` label suffix.  Forwarded params resolve at the
    wrapper's call sites instead and return []."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return [arg.value.partition("|")[0]]
    if isinstance(arg, ast.JoinedStr):
        first = arg.values[0] if arg.values else None
        if isinstance(first, ast.Constant):
            base = str(first.value).partition("|")[0]
            # a fully-literal base ends before the first dynamic segment;
            # `f"k_steps_saved|leg={leg}"` resolves, `f"slot_{kind}"` not
            if "|" in str(first.value) or len(arg.values) == 1:
                return [base]
        return []
    if isinstance(arg, ast.IfExp):
        return (_first_arg_literal_base(arg.body)
                + _first_arg_literal_base(arg.orelse))
    if isinstance(arg, ast.BinOp):  # name + label_suffix: base is left
        return _first_arg_literal_base(arg.left)
    return []


def _collect_code_counters(root: str) -> Set[str]:
    """Counter names recorded anywhere in the package + chip_smoke.py,
    resolved through chokepoint wrappers (a function whose body forwards
    its own param to ``record_counter`` makes every literal at ITS call
    sites a counter name)."""
    files = _iter_package_files(root)
    trees: List[Tuple[str, ast.Module]] = []
    for path in files:
        text = _read(path)
        if text is None:
            continue
        try:
            trees.append((path, ast.parse(text)))
        except SyntaxError:
            continue
    counters: Set[str] = set()
    # wrapper name -> (call-site positional index of the forwarded name
    # param with any bound self/cls dropped, or -1 for keyword-only;
    # keyword name).  record_counter itself is the (0, "name") root.
    wrappers: Dict[str, Tuple[int, str]] = {"record_counter": (0, "name")}

    def _base_param_name(arg: ast.expr, params: Set[str]) -> Optional[str]:
        """Name of the param the metric-name expression FORWARDS as its
        base (the chokepoint idiom): a bare param, an f-string whose
        base segment is one (``f"{name}|leg={leg}"``), or ``name + sfx``.
        A param that only interpolates a LABEL VALUE
        (``f"k_steps_saved|leg={leg}"``) is not forwarding — the literal
        base resolves right here, and treating the function as a wrapper
        would register its call-site argument strings as counter names."""
        if isinstance(arg, ast.Name):
            return arg.id if arg.id in params else None
        if isinstance(arg, ast.JoinedStr) and arg.values:
            first = arg.values[0]
            if (isinstance(first, ast.FormattedValue)
                    and isinstance(first.value, ast.Name)
                    and first.value.id in params):
                return first.value.id
            return None
        if isinstance(arg, ast.BinOp):
            return _base_param_name(arg.left, params)
        return None

    def _name_arg(call: ast.Call, fn: str) -> Optional[ast.expr]:
        """The metric-name argument at a recorder/wrapper call site:
        the registered keyword if present, else the positional slot."""
        idx, kw = wrappers[fn]
        for k in call.keywords:
            if k.arg == kw:
                return k.value
        if 0 <= idx < len(call.args):
            return call.args[idx]
        return None

    # pass 1 (fixpoint): wrapper discovery — a function that forwards
    # its own param as the NAME argument of record_counter or of an
    # already-known wrapper is itself a wrapper.  The fixpoint makes the
    # idiom transitive: `_reject(..., counter=...)` forwarding to
    # `self._counter(counter)` forwarding to `record_counter(name)`
    # registers `_reject` call-site literals too.
    # each tree walked once: its nodes, and each function's calls (in
    # ast.walk order, so the first forwarding call wins as it always has)
    nodes = {path: list(ast.walk(tree)) for path, tree in trees}
    functions = [
        (node, [sub for sub in ast.walk(node) if isinstance(sub, ast.Call)])
        for path, _ in trees for node in nodes[path]
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))]
    changed = True
    while changed:
        changed = False
        for node, calls in functions:
            if node.name in wrappers:
                continue
            pos_params = node.args.posonlyargs + node.args.args
            params = {a.arg for a in (pos_params
                                      + node.args.kwonlyargs)}
            for sub in calls:
                fn = _dotted(sub.func).rsplit(".", 1)[-1]
                if fn not in wrappers:
                    continue
                arg = _name_arg(sub, fn)
                if arg is None:
                    continue
                pname = _base_param_name(arg, params)
                if pname is None:
                    continue
                ordered = [a.arg for a in pos_params]
                if ordered and ordered[0] in ("self", "cls"):
                    ordered = ordered[1:]   # bound at call sites
                idx = (ordered.index(pname) if pname in ordered
                       else -1)            # kwonly: keyword-only
                wrappers[node.name] = (idx, pname)
                changed = True
                break
    # pass 2: collect literal (or module-const) names at every recorder
    # and wrapper call site
    for path, _ in trees:
        consts = {t.id: n.value.value for n in nodes[path]
                  if isinstance(n, ast.Assign)
                  and isinstance(n.value, ast.Constant)
                  and isinstance(n.value.value, str)
                  for t in n.targets if isinstance(t, ast.Name)}
        for node in nodes[path]:
            if not isinstance(node, ast.Call):
                continue
            fn = _dotted(node.func).rsplit(".", 1)[-1]
            if fn not in wrappers:
                continue
            arg = _name_arg(node, fn)
            if arg is None:
                continue
            if (isinstance(arg, ast.Name) and arg.id in consts):
                counters.add(consts[arg.id].partition("|")[0])
            else:
                counters.update(_first_arg_literal_base(arg))
    return {c for c in counters if c}


def check_counter_table(root: str) -> List[Drift]:
    md = _read(os.path.join(root, "README.md"))
    if md is None:
        return [Drift("counter-table", "README.md missing", "README.md")]
    doc_names: List[str] = []
    for name in _table_rows(md, "Telemetry counters"):
        base = name.partition("\\|")[0].partition("|")[0]
        for part in base.split(" / "):
            part = part.strip().strip("`")
            if part:
                doc_names.append(part)
    code = _collect_code_counters(root)
    drifts: List[Drift] = []

    def documented(counter: str) -> bool:
        for doc in doc_names:
            if doc.endswith("*"):
                if counter.startswith(doc[:-1]):
                    return True
            elif counter == doc:
                return True
        return False

    for counter in sorted(code):
        if not documented(counter):
            drifts.append(Drift(
                "counter-table",
                f"counter '{counter}' is recorded in code but missing "
                f"from the README 'Telemetry counters' table",
                "README.md"))
    for doc in doc_names:
        if doc.endswith("*"):
            hit = any(c.startswith(doc[:-1]) for c in code)
        else:
            hit = doc in code
        if not hit:
            drifts.append(Drift(
                "counter-table",
                f"README counter-table row '{doc}' matches no counter "
                f"recorded anywhere in the code (never recorded means "
                f"never exported)",
                "README.md"))
    return drifts


# ---------------------------------------------------------------------------
# check 2: pytest markers vs pyproject registry
# ---------------------------------------------------------------------------

def check_markers(root: str) -> List[Drift]:
    pyproject = _read(os.path.join(root, "pyproject.toml"))
    if pyproject is None:
        return [Drift("markers", "pyproject.toml missing",
                      "pyproject.toml")]
    m = re.search(r"markers\s*=\s*\[(.*?)\]", pyproject, re.DOTALL)
    registered: Set[str] = set()
    if m:
        for entry in re.findall(r'"([^":]+):', m.group(1)):
            registered.add(entry.strip())
    used: Set[str] = set()
    tests_dir = os.path.join(root, "tests")
    if os.path.isdir(tests_dir):
        for fname in sorted(os.listdir(tests_dir)):
            if not fname.endswith(".py"):
                continue
            text = _read(os.path.join(tests_dir, fname)) or ""
            used.update(re.findall(r"pytest\.mark\.(\w+)", text))
    used -= _BUILTIN_MARKS
    drifts: List[Drift] = []
    for name in sorted(used - registered):
        drifts.append(Drift(
            "markers",
            f"pytest marker '{name}' is used in tests/ but not "
            f"registered in pyproject [tool.pytest.ini_options] markers",
            "pyproject.toml"))
    for name in sorted(registered - used - _SELECTOR_MARKS):
        drifts.append(Drift(
            "markers",
            f"pytest marker '{name}' is registered in pyproject but "
            f"used by no test (dead registry entry)",
            "pyproject.toml"))
    return drifts


# ---------------------------------------------------------------------------
# check 3: tracer phase table vs README phase table
# ---------------------------------------------------------------------------

def check_phase_table(root: str) -> List[Drift]:
    tracer_text = _read(os.path.join(root, PKG_NAME, "obs", "tracer.py"))
    md = _read(os.path.join(root, "README.md"))
    if tracer_text is None or md is None:
        return [Drift("phase-table", "obs/tracer.py or README.md missing",
                      "obs/tracer.py")]
    try:
        tree = ast.parse(tracer_text)
    except SyntaxError as err:
        return [Drift("phase-table", f"unparseable tracer.py: {err}",
                      "obs/tracer.py")]
    known: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "KNOWN_PHASES":
                    for sub in ast.walk(node.value):
                        if (isinstance(sub, ast.Constant)
                                and isinstance(sub.value, str)):
                            known.add(sub.value)
    if not known:
        return [Drift("phase-table",
                      "obs/tracer.py no longer declares KNOWN_PHASES",
                      "obs/tracer.py")]
    doc: Set[str] = set()
    for name in _table_rows(md, "Span / phase names"):
        for part in name.split(" / "):
            part = part.strip().strip("`")
            if part:
                doc.add(part)
    drifts: List[Drift] = []
    for name in sorted(known - doc):
        drifts.append(Drift(
            "phase-table",
            f"phase '{name}' is in obs/tracer.KNOWN_PHASES but missing "
            f"from the README 'Span / phase names' table",
            "README.md"))
    for name in sorted(doc - known):
        drifts.append(Drift(
            "phase-table",
            f"README phase-table row '{name}' is not in "
            f"obs/tracer.KNOWN_PHASES (G08 would reject a span using it)",
            "obs/tracer.py"))
    return drifts


# ---------------------------------------------------------------------------
# check 4: calibration-coefficient provenance
# ---------------------------------------------------------------------------

#: the files holding the plan model's pinned cost-model literals.
CALIBRATED_FILES = ("runtime/plan.py", "runtime/plan_search.py")

#: a provenance citation: ``# anchor: scripts/calibrate_plan_torch.py on
#: NVIDIA <card>, <limit> W`` ties the literal to the calibration script's
#: run on a named card at a named power limit (the script's ``--fit``
#: refits it); ``# prior: <rationale>`` documents an unmeasured guess AND
#: its recalibration story.  ``#:`` (sphinx-style) counts too.
_CITE_RE = re.compile(r"#:?\s*(anchor: scripts/calibrate_plan_torch\.py on "
                      r"NVIDIA [^,]+, \d+\.\d+ W$|prior:\s*\S)")

#: what no line of those files may name: a TPU record or chip (a TPU
#: number is not the port's)
_TPU_RE = re.compile(r"BENCH_r\d|MULTICHIP_r\d|v5e|HBM_BYTES_V5E")


def _is_numeric_literal(node: ast.expr) -> bool:
    """A scalar numeric expression made only of constants: ``169.5``,
    ``6_921_420_800``, ``1 << 28``, ``-0.5``.  Tuples/menus (enumerated
    search axes, not calibrated coefficients) don't count."""
    if isinstance(node, ast.Constant):
        return (isinstance(node.value, (int, float))
                and not isinstance(node.value, bool))
    if isinstance(node, ast.UnaryOp):
        return _is_numeric_literal(node.operand)
    if isinstance(node, ast.BinOp):
        return (_is_numeric_literal(node.left)
                and _is_numeric_literal(node.right))
    return False


def check_calibration(root: str) -> List[Drift]:
    """Every pinned cost-model literal must carry its provenance, and no
    line may name a TPU record or chip.

    The plan search ranks candidate plans with module-level numeric
    coefficients; a literal without a citation is a number nobody can
    recalibrate — ``scripts/calibrate_plan_torch.py --fit`` needs to know
    which were measured on which card (``anchor:``) and which are
    documented guesses awaiting their first measurement (``prior:``).
    The citation rides the assignment line or the comment block directly
    above it."""
    drifts: List[Drift] = []
    for rel in CALIBRATED_FILES:
        path = os.path.join(root, PKG_NAME, rel.replace("/", os.sep))
        text = _read(path)
        if text is None:
            drifts.append(Drift("calibration", f"{rel} missing",
                                PKG_NAME + "/" + rel))
            continue
        try:
            tree = ast.parse(text)
        except SyntaxError as err:
            drifts.append(Drift("calibration",
                                f"unparseable {rel}: {err}",
                                PKG_NAME + "/" + rel))
            continue
        lines = text.splitlines()
        for i, line in enumerate(lines, start=1):
            if _TPU_RE.search(line):
                drifts.append(Drift(
                    "calibration",
                    f"{rel}:{i} names a TPU record or chip — the port's "
                    f"coefficients come from its own calibration on the "
                    f"card",
                    PKG_NAME + "/" + rel))
        for node in tree.body:
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            name = node.targets[0].id
            if not re.fullmatch(r"[A-Z][A-Z0-9_]*", name):
                continue
            if not _is_numeric_literal(node.value):
                continue
            # trailing comment on the assignment line itself ...
            cited = bool(_CITE_RE.search(lines[node.lineno - 1]))
            # ... or anywhere in the contiguous comment block above it
            i = node.lineno - 2
            while not cited and i >= 0 and lines[i].lstrip().startswith("#"):
                cited = bool(_CITE_RE.search(lines[i]))
                i -= 1
            if not cited:
                drifts.append(Drift(
                    "calibration",
                    f"pinned coefficient {name} ({rel}:{node.lineno}) "
                    f"carries no provenance citation — add '# anchor: "
                    f"scripts/calibrate_plan_torch.py on NVIDIA <card>, "
                    f"<limit> W' (measured there) or '# prior: "
                    f"<rationale>' (documented guess + its recalibration "
                    f"story)",
                    PKG_NAME + "/" + rel))
    return drifts


# ---------------------------------------------------------------------------
# the checks' table and the command
# ---------------------------------------------------------------------------

CHECKS = (
    ("counter-table", check_counter_table),
    ("markers", check_markers),
    ("phase-table", check_phase_table),
    ("calibration", check_calibration),
)

#: the reference's checks that read its benchmark (``bench.py``'s record
#: blocks against ``obs/benchdiff``, its full-study child's overrides):
#: the port has no benchmark yet, so they do not run
WAITING = {
    "record-blocks": "the top-level blocks of the benchmark's JSON record "
                     "vs obs/benchdiff's ALIGNED/CONTEXT/INFORMATIONAL "
                     "classification",
    "child-flags": "the benchmark's full-study child overrides vs the "
                   "child block's assignments",
}
WAITING_NOTE = ("not run: the port has no benchmark yet; this check waits "
                "for the port's benchmark PR")

#: one line a check, for ``--explain``
EXPLAIN = {
    "counter-table": "counters recorded in the port's code (record_counter "
                     "and its chokepoint wrappers) vs the 'Telemetry "
                     "counters' table in the README's PyTorch/CUDA port "
                     "section",
    "markers": "pytest markers used in tests/ vs pyproject.toml's "
               "registry, both directions",
    "phase-table": "the port's obs/tracer.KNOWN_PHASES vs the 'Span / "
                   "phase names' table in the README's PyTorch/CUDA port "
                   "section",
    "calibration": "every coefficient of runtime/plan.py and "
                   "runtime/plan_search.py cites 'anchor: "
                   "scripts/calibrate_plan_torch.py on NVIDIA <card>, "
                   "<limit> W' or 'prior: <rationale>'; no line names a "
                   "TPU record or chip",
    **{k: f"{v} — {WAITING_NOTE}" for k, v in WAITING.items()},
}

#: repo-relative path predicates per check — the ``--diff`` scope: a
#: check runs when ANY file it reads changed.  Predicates take a
#: repo-relative posix path.
CHECK_TRIGGERS = {
    "counter-table": lambda p: (p in ("README.md", "chip_smoke.py")
                                or (p.startswith(PKG_NAME + "/")
                                    and p.endswith(".py"))),
    "markers": lambda p: (p == "pyproject.toml"
                          or (p.startswith("tests/")
                              and p.endswith(".py"))),
    "phase-table": lambda p: p in ("README.md",
                                   PKG_NAME + "/obs/tracer.py"),
    "calibration": lambda p: p in tuple(PKG_NAME + "/" + rel
                                        for rel in CALIBRATED_FILES),
}


def check_contracts(root: Optional[str] = None,
                    only: Optional[Sequence[str]] = None) -> List[Drift]:
    root = os.path.abspath(root or repo_root())
    drifts: List[Drift] = []
    for kind, check in CHECKS:
        if only is not None and kind not in only:
            continue
        drifts.extend(check(root))
    return drifts


def main(argv: Optional[Sequence[str]] = None) -> int:
    kinds = [k for k, _ in CHECKS] + list(WAITING)
    parser = argparse.ArgumentParser(
        prog="llm_interpretation_replication_tpu_torch lint contracts",
        description="cross-artifact contract checking over the port: code "
                    "vs the README port section's tables, the pyproject "
                    "marker registry, and the plan model's calibration "
                    "provenance")
    parser.add_argument("--root", default=None,
                        help="tree to check (default: this repo)")
    parser.add_argument("--format", choices=["text", "json"],
                        default="text")
    parser.add_argument("--only", default=None, metavar="KIND",
                        help="run one check: " + ", ".join(kinds))
    parser.add_argument("--diff", action="store_true",
                        help="run only the checks whose artifacts "
                             "changed vs git HEAD (cheap CI mode; git "
                             "unavailable falls back to all checks)")
    parser.add_argument("--explain", default=None, metavar="KIND",
                        help="print what a check compares and exit ('all' "
                             "for every check)")
    args = parser.parse_args(argv)
    if args.explain:
        wanted = kinds if args.explain == "all" else [args.explain]
        if any(k not in EXPLAIN for k in wanted):
            print(f"unknown check {args.explain!r}; known: "
                  f"{', '.join(kinds)}")
            return 2
        for k in wanted:
            print(f"{k}: {EXPLAIN[k]}")
        return 0
    root = os.path.abspath(args.root or repo_root())
    if args.only in WAITING:
        print(f"{args.only}: {WAITING_NOTE}")
        return 0
    if args.only:
        table = dict(CHECKS)
        if args.only not in table:
            print(f"unknown check {args.only!r}; known: {', '.join(kinds)}")
            return 2
        drifts = table[args.only](root)
    elif args.diff:
        from .cli import changed_files

        changed = changed_files(root)
        if changed is None:
            drifts = check_contracts(root)
        else:
            triggered = [kind for kind, _ in CHECKS
                         if any(CHECK_TRIGGERS[kind](p) for p in changed)]
            drifts = check_contracts(root, only=triggered)
            if args.format == "text":
                skipped = [k for k, _ in CHECKS if k not in triggered]
                if skipped:
                    print(f"# --diff: skipped {', '.join(skipped)} "
                          f"(no relevant artifact changed)")
    else:
        drifts = check_contracts(root)
    if args.format == "json":
        print(json.dumps({"drift": [d.to_json() for d in drifts]},
                         indent=2))
    else:
        for d in drifts:
            print(d.format())
        print(f"{len(drifts)} contract drift(s)" if drifts
              else "contracts clean: code, docs, and config agree")
    return 1 if drifts else 0


if __name__ == "__main__":
    raise SystemExit(main())
