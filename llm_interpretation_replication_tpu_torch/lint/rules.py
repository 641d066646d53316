"""The port's lint rules: the reference's G00-G11 catalogue read for
PyTorch.

Each rule is a small class plugging into :class:`..lint.visitor.LintVisitor`
hooks.  The catalogue (also printed by ``lint --explain``):

- **G01 host-sync** — a device->host sync inside a device region (a
  ``launch`` pipeline closure in a hot module and the helpers it reaches,
  :mod:`.visitor`): ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``.to("cpu")``, ``torch.cuda.synchronize()`` or a stream's / event's
  ``.synchronize()``, and ``float()``/``int()``/``bool()`` or
  ``np.asarray``/``np.array`` on a tensor.  Each one waits for every
  kernel queued before it and serializes the pipeline the engine's
  launch/consume overlap builds.  The sanctioned fetch points are the
  pipeline's ``consume`` closures and ``strict.sanctioned_fetch()``
  blocks — ``runtime/strict.py`` arms the same contract at run time with
  ``torch.cuda.set_sync_debug_mode``.  ``.item()`` is flagged anywhere in
  a hot-path module, as in the reference.
- **G02 tensor-control-flow** — an ``if``, ``while``, ``assert`` or
  conditional expression on a tensor value inside a device region.  On
  PyTorch this is not a retrace (there is no trace) but a hidden
  ``Tensor.__bool__``: a device->host sync that drains the pipeline just
  as G01's do.  The rule keeps the reference's id; keep the decision on
  the device (``torch.where``) or take it in ``consume``.
- **G03 key-reuse** and **G04 jit-boundary** have no PyTorch meaning:
  the port draws from explicit ``torch.Generator`` objects whose state
  advances with every draw, and it has no jit boundary.  Their rows stay
  in :data:`RULES` so ``lint --explain`` says why they are not run.
- **G05 broad-except**, **G06 telemetry-discipline**, **G07
  cache-scale-awareness** (``models/decoder.KVCache.k``/``.v`` and their
  int8 ``k_scale``/``v_scale``; torch re-layouts count with jnp/np
  ones), **G08 span-hygiene** — the reference's rules as written, over
  the port's fault layers, ``utils/telemetry.FAULT_KINDS`` and
  ``obs/tracer.KNOWN_PHASES``.

Rules G09-G11 (guarded-by, lock-order, blocking-under-lock) are NOT in
this module: they need the whole tree at once — thread roots in serve/
reach state in utils/ — so they live in :mod:`.threads` as a third
analysis layer over the same Finding/suppression/baseline machinery.
Their catalogue rows are in :data:`RULES` below so ``lint --explain``
covers them.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from ..obs.tracer import KNOWN_PHASES
from ..utils.telemetry import FAULT_KINDS
from .visitor import METADATA_ATTRS, FileContext, LintVisitor, dotted_name

#: rule id -> (title, one-line summary) — the CLI's --explain table.
RULES: Dict[str, Tuple[str, str]] = {
    "G00": ("syntax-error", "file failed to parse; nothing else was checked"),
    "G01": ("host-sync", "device->host sync inside a device region "
                         "(.item(), .tolist(), .cpu(), .numpy(), "
                         ".to('cpu'), synchronize(), float()/int()/bool() "
                         "or np.asarray on a tensor, in a launch closure "
                         "or a helper it reaches)"),
    "G02": ("tensor-control-flow", "Python if/while/assert/conditional "
                                   "expression on a tensor inside a "
                                   "device region: a hidden "
                                   "Tensor.__bool__ sync that drains the "
                                   "pipeline (the reference's retrace "
                                   "rule, read for PyTorch)"),
    "G03": ("key-reuse", "not run on PyTorch: the port draws from explicit "
                         "torch.Generator objects whose state advances "
                         "with every draw, so no key can be consumed "
                         "twice"),
    "G04": ("jit-boundary", "not run on PyTorch: the port runs eagerly and "
                            "has no jit boundary (no trace cache to key on "
                            "an instance, no static arguments to pin)"),
    "G05": ("broad-except", "broad except swallows errors before "
                            "runtime/faults.py classification"),
    "G06": ("telemetry-discipline", "metric names must be literal (or "
                                    "forwarded params); labels ride the "
                                    "name|k=v convention with literal "
                                    "keys; record_fault literals must be "
                                    "registered FAULT_KINDS"),
    "G07": ("cache-scale-awareness", "reshape/gather/concat directly on "
                                     "KVCache.k/.v outside ops helpers — "
                                     "int8 scales must ride along "
                                     "(cache_kv_map)"),
    "G08": ("span-hygiene", "tracer spans must be context-managed and "
                            "phase= tags must come from the known phase "
                            "table"),
    # G09-G11 live in lint/threads.py (the whole-tree concurrency layer),
    # not in default_rules(): they need every module at once, not one file
    "G09": ("guarded-by", "shared attribute reached from >=2 thread roots "
                          "mutated outside its consistently-held lock "
                          "(incl. non-atomic read-modify-write)"),
    "G10": ("lock-order", "cycle in the global lock-acquisition ordering "
                          "graph (or non-reentrant self-reacquisition) — "
                          "a static deadlock"),
    "G11": ("blocking-under-lock", "blocking call (sleep, result/join "
                                   "without timeout=0, network) while "
                                   "holding a contended lock"),
}

#: numpy fetch calls, as the file's imports resolve them
_FETCH_CALLS = {"numpy.asarray", "numpy.array", "np.asarray", "np.array"}
_CAST_BUILTINS = {"float", "int", "bool"}
#: tensor methods that copy to the host and wait for the stream
_SYNC_METHODS = {"cpu", "numpy"}


def _to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``."""
    args = list(call.args[:1]) + [kw.value for kw in call.keywords
                                  if kw.arg == "device"]
    return any(isinstance(a, ast.Constant) and a.value == "cpu"
               for a in args)


class HostSyncRule:
    """G01 — see module docstring."""

    rule = "G01"

    def _sync(self, node: ast.Call, v: LintVisitor) -> Optional[str]:
        """What makes ``node`` a sync, or None."""
        fn = v.resolve(dotted_name(node.func))
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in _SYNC_METHODS:
                return f".{attr}()"
            if attr == "to" and _to_cpu(node):
                return '.to("cpu")'
            if attr == "synchronize":
                return f"{fn or '.synchronize'}()"
            if attr == "tolist" and v.is_tensor(node.func.value):
                return ".tolist() on a tensor"
        if node.args and (fn in _FETCH_CALLS or fn in _CAST_BUILTINS) \
                and v.is_tensor(node.args[0]):
            return f"{fn}() on a tensor"
        return None

    def check_call(self, node: ast.Call, ctx: FileContext,
                   v: LintVisitor) -> None:
        if v.sanctioned():
            return
        frame = v.function
        in_device = frame is not None and frame.in_device_region
        is_item = (isinstance(node.func, ast.Attribute)
                   and node.func.attr == "item")
        if is_item and (in_device or ctx.hot_module):
            where = (frame.region_desc() if in_device
                     else "a hot-path module")
            v.report(self.rule, node,
                     f".item() copies one element to the host and waits "
                     f"for the stream inside {where}; fetch whole tensors "
                     f"at the sanctioned consume points instead")
            return
        if not in_device:
            return
        what = self._sync(node, v)
        if what:
            v.report(self.rule, node,
                     f"{what} waits for every kernel queued before it "
                     f"inside {frame.region_desc()}; move the fetch to the "
                     f"pipeline's consume callback (or a "
                     f"strict.sanctioned_fetch() block)")


class TensorControlFlowRule:
    """G02 — see module docstring."""

    rule = "G02"

    @staticmethod
    def _bool_operands(test: ast.expr) -> List[ast.expr]:
        """The values Python calls ``__bool__`` on to decide ``test``."""
        if isinstance(test, ast.BoolOp):
            return [o for v in test.values
                    for o in TensorControlFlowRule._bool_operands(v)]
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return TensorControlFlowRule._bool_operands(test.operand)
        return [test]

    @staticmethod
    def _skip(test: ast.expr) -> bool:
        """Tests that interrogate Python structure, not tensor values."""
        return isinstance(test, ast.Call) and dotted_name(test.func) in (
            "isinstance", "hasattr", "callable", "len")

    def _check(self, node, test: ast.expr, ctx: FileContext,
               v: LintVisitor, kind: str) -> None:
        frame = v.function
        if frame is None or not frame.in_device_region or v.sanctioned():
            return
        hits = [o for o in self._bool_operands(test)
                if not self._skip(o) and v.is_tensor(o)]
        if hits:
            what = ", ".join(ast.unparse(o) for o in hits)
            v.report(self.rule, node,
                     f"Python {kind} on tensor value(s) {what} inside "
                     f"{frame.region_desc()} calls Tensor.__bool__ — a "
                     f"hidden device->host sync that drains the pipeline; "
                     f"keep the decision on the device (torch.where) or "
                     f"take it in consume")

    def check_if(self, node: ast.If, ctx, v) -> None:
        self._check(node, node.test, ctx, v, "if")

    def check_while(self, node: ast.While, ctx, v) -> None:
        self._check(node, node.test, ctx, v, "while")

    def check_ifexp(self, node: ast.IfExp, ctx, v) -> None:
        self._check(node, node.test, ctx, v, "conditional expression")

    def check_assert(self, node: ast.Assert, ctx, v) -> None:
        self._check(node, node.test, ctx, v, "assert")


class BroadExceptRule:
    """G05 — see module docstring."""

    rule = "G05"

    def check_excepthandler(self, node: ast.ExceptHandler, ctx: FileContext,
                            v: LintVisitor) -> None:
        if not ctx.fault_module:
            return
        def is_broad(t) -> bool:
            if t is None:
                return True
            if isinstance(t, ast.Name):
                return t.id in ("Exception", "BaseException")
            if isinstance(t, ast.Attribute):
                return t.attr in ("Exception", "BaseException")
            if isinstance(t, ast.Tuple):  # except (Exception, OSError):
                return any(is_broad(e) for e in t.elts)
            return False

        if not is_broad(node.type):
            return
        for sub in ast.walk(node):
            if isinstance(sub, ast.Raise):
                return  # re-raises: classification still sees the error
        label = ("bare except" if node.type is None
                 else f"except {dotted_name(node.type) or 'Exception'}")
        v.report(self.rule, node,
                 f"{label} swallows device errors before runtime/faults.py "
                 f"can classify them (RESOURCE_EXHAUSTED never reaches the "
                 f"batch back-off ladder); catch typed exceptions, route "
                 f"through faults.is_oom/oom_detail, or add "
                 f"'# graftlint: disable=G05 <reason>' if the swallow is "
                 f"deliberate")


#: the telemetry recording API (utils/telemetry.py) whose first argument
#: is a metric name — the G06 surface.
_TELEMETRY_RECORDERS = {"record_counter", "record_sample", "record_hist"}

#: label-section skeleton of the `name|k=v,k2=v2` convention after
#: replacing dynamic values with {}: literal keys, comma-separated.
_LABELS_SKELETON_RE = re.compile(
    r"[A-Za-z_][A-Za-z0-9_]*=(\{\}|[A-Za-z0-9_.-]*)"
    r"(,[A-Za-z_][A-Za-z0-9_]*=(\{\}|[A-Za-z0-9_.-]*))*$")


class TelemetryDisciplineRule:
    """G06 — see module docstring.

    The telemetry layer keys on PLAIN STRINGS, and the Prometheus
    exporter (obs/metrics.split_labeled_name) re-splits the
    ``name|k=v,k2=v2`` convention into one labeled family.  That only
    works when metric names are statically enumerable: a dynamically
    concatenated name (``"slot_" + kind``) mints an unbounded family the
    README counter table cannot document and bench-diff cannot align.
    Allowed spellings for the name argument of
    record_counter/record_sample/record_hist:

    - a string literal (labels, if any, after ``|`` with literal keys);
    - an f-string whose BASE (before ``|``) is literal and whose label
      section has literal keys — values may interpolate
      (``f"k_steps_saved|leg={leg}"``);
    - a forwarded parameter of the enclosing function — the chokepoint-
      helper idiom (scheduler._counter, slots._slot_counter); the
      helper's callers are checked instead (and `lint contracts`
      enumerates names through those chokepoints);
    - a module-level string constant (runtime/strict.RECOMPILE_COUNTER);
    - a forwarded parameter plus a precomputed label suffix
      (``name + self._label_suffix``).

    ``record_fault`` is the registry-side twin: a LITERAL kind (either
    IfExp arm counts) must be a member of
    :data:`..utils.telemetry.FAULT_KINDS` — the flight recorder's
    trigger set and every fault listener match on exact kinds, so a
    typo'd literal forks an event stream nothing ever reads.  Dynamic
    kinds (forwarded params, computed names) are the chokepoint idiom
    and stay out of scope here.
    """

    rule = "G06"

    def __init__(self):
        self._module_consts: Dict[str, str] = {}

    def check_module(self, tree: ast.Module, ctx: FileContext,
                     v: LintVisitor) -> None:
        self._module_consts = {}
        for node in tree.body:
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Constant) and isinstance(
                    node.value.value, str):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self._module_consts[t.id] = node.value.value

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _is_param(name: str, frame) -> bool:
        f = frame
        while f is not None:
            if name in f.params:
                return True
            f = f.parent
        return False

    def _check_literal(self, text: str, node, v: LintVisitor) -> None:
        if "|" not in text:
            return
        base, _, labels = text.partition("|")
        if not base or not _LABELS_SKELETON_RE.match(labels or ""):
            v.report(self.rule, node,
                     f"malformed labeled metric name {text!r}: the "
                     f"convention is 'name|k=v,k2=v2' with literal "
                     f"identifier keys (obs/metrics.split_labeled_name "
                     f"cannot re-split anything else into one Prometheus "
                     f"family)")

    def _check_fstring(self, node: ast.JoinedStr, frame,
                       v: LintVisitor) -> None:
        # build the skeleton: literal text stays, FormattedValue -> {}
        parts: List[str] = []
        dynamic_names: List[Optional[str]] = []
        for seg in node.values:
            if isinstance(seg, ast.Constant):
                parts.append(str(seg.value))
                dynamic_names.append(None)
            else:  # FormattedValue
                parts.append("{}")
                inner = seg.value if isinstance(
                    seg, ast.FormattedValue) else None
                dynamic_names.append(
                    inner.id if isinstance(inner, ast.Name) else "")
        skeleton = "".join(parts)
        base, sep, labels = skeleton.partition("|")
        if "{}" in base:
            # the one sanctioned dynamic base: a single forwarded param
            # (the chokepoint-helper idiom, e.g. f"{name}|leg={leg}")
            first_dyn = next((n for p, n in zip(parts, dynamic_names)
                              if p == "{}"), "")
            forwarding = (base == "{}" and first_dyn
                          and self._is_param(first_dyn, frame))
            if not forwarding:
                v.report(self.rule, node,
                         "dynamically-constructed metric name: the base "
                         "before '|' must be a string literal (or a "
                         "forwarded parameter of a chokepoint helper) — "
                         "dynamic names mint unbounded metric families "
                         "the counter table and exporter cannot track")
                return
        if sep and not _LABELS_SKELETON_RE.match(labels):
            v.report(self.rule, node,
                     "labeled metric name must spell labels as "
                     "'|k=v,k2=v2' with LITERAL identifier keys — "
                     "dynamic label keys break the one-family Prometheus "
                     "re-split")

    def _leftmost(self, node: ast.expr) -> ast.expr:
        while isinstance(node, ast.BinOp):
            node = node.left
        return node

    # -- the check ---------------------------------------------------------

    def check_call(self, node: ast.Call, ctx: FileContext,
                   v: LintVisitor) -> None:
        fn = dotted_name(node.func)
        tail = fn.rsplit(".", 1)[-1]
        if tail == "record_fault":
            if node.args:
                self._check_fault_kind(node.args[0], node, v)
            return
        if tail not in _TELEMETRY_RECORDERS:
            return
        if not node.args:
            return
        self._check_name_expr(node.args[0], v.function, node, v)

    def _check_fault_kind(self, arg: ast.expr, node: ast.Call,
                          v: LintVisitor) -> None:
        if isinstance(arg, ast.IfExp):
            self._check_fault_kind(arg.body, node, v)
            self._check_fault_kind(arg.orelse, node, v)
            return
        if not (isinstance(arg, ast.Constant)
                and isinstance(arg.value, str)):
            return  # dynamic kind: chokepoint territory, out of scope
        if arg.value not in FAULT_KINDS:
            v.report(self.rule, node,
                     f"unregistered fault kind {arg.value!r}: "
                     f"record_fault literals must be members of "
                     f"utils/telemetry.FAULT_KINDS — the flight "
                     f"recorder's triggers and fault listeners match on "
                     f"exact kinds, so a typo forks an event stream "
                     f"nothing ever reads")

    def _check_name_expr(self, arg: ast.expr, frame, node: ast.Call,
                         v: LintVisitor) -> None:
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            self._check_literal(arg.value, node, v)
            return
        if isinstance(arg, ast.JoinedStr):
            self._check_fstring(arg, frame, v)
            return
        if isinstance(arg, ast.IfExp):
            # `"hit" if ok else "miss"` — enumerable iff both arms are
            self._check_name_expr(arg.body, frame, node, v)
            self._check_name_expr(arg.orelse, frame, node, v)
            return
        if isinstance(arg, ast.Name):
            if self._is_param(arg.id, frame):
                return  # chokepoint forwarding: callers are the surface
            if arg.id in self._module_consts:
                self._check_literal(self._module_consts[arg.id], node, v)
                return
            v.report(self.rule, node,
                     f"metric name '{arg.id}' is not statically "
                     f"resolvable (not a literal, module constant, or "
                     f"forwarded parameter) — telemetry names must be "
                     f"enumerable for the counter table and the "
                     f"Prometheus exporter")
            return
        if isinstance(arg, ast.BinOp):
            left = self._leftmost(arg)
            if isinstance(left, ast.Name) and self._is_param(
                    left.id, frame):
                return  # name + precomputed label suffix (scheduler idiom)
            v.report(self.rule, node,
                     "dynamically-concatenated metric name: concatenation "
                     "mints metric families the README counter table and "
                     "bench-diff cannot track; use a literal base with "
                     "the 'name|k=v' labeled convention instead")
            return
        v.report(self.rule, node,
                 "metric name is not statically resolvable; pass a "
                 "string literal (labels via 'name|k=v' with literal "
                 "keys) or forward a chokepoint helper's parameter")


#: array-manipulation callables that re-layout cache storage — the exact
#: operations that must keep k_scale/v_scale aligned with the int8 codes.
_CACHE_MANIP_FNS = {
    "reshape", "concatenate", "stack", "take", "take_along_axis",
    "gather", "dynamic_slice", "dynamic_update_slice", "pad", "tile",
    "repeat", "moveaxis", "swapaxes", "transpose", "broadcast_to",
    "roll", "flip", "split", "where", "zeros_like", "empty_like",
}

#: modules allowed to touch KVCache.k/.v storage directly: the ops
#: helpers (quant/attention readers) and the decoder that OWNS the cache
#: layout (cache_kv_map and the append/fold sites live there).
_CACHE_EXEMPT_PATHS = ("/ops/", "ops/", "models/decoder.py")


class CacheScaleAwarenessRule:
    """G07 — see module docstring.

    The int8-KV scale-plumbing audit chased exactly this bug class by
    hand: a reshape/gather/concat applied to ``cache.k``/``cache.v`` codes
    without the same transform on ``k_scale``/``v_scale`` silently
    dequantizes with misaligned scales.  Every cache-reshaping site must
    route through ``models/decoder.cache_kv_map`` (which maps codes AND
    scales) or live in the exempt helper modules.  Metadata access
    (``cache.k.shape``/``.size``/``.dtype``) is host-static and fine."""

    rule = "G07"

    @classmethod
    def _cache_kv_operands(cls, node: ast.expr) -> List[ast.Attribute]:
        """``.k``/``.v`` attribute accesses on cache-named bases in the
        subtree, skipping metadata accesses (``cache.k.shape`` never
        touches storage)."""
        hits: List[ast.Attribute] = []

        def walk(n: ast.AST) -> None:
            if isinstance(n, ast.Attribute):
                if n.attr in METADATA_ATTRS:
                    return  # metadata: don't descend into its base
                if n.attr in ("k", "v"):
                    base = dotted_name(n.value)
                    last = base.rsplit(".", 1)[-1].lower()
                    if "cache" in last or last == "kv":
                        hits.append(n)
            for child in ast.iter_child_nodes(n):
                walk(child)

        walk(node)
        return hits

    def check_call(self, node: ast.Call, ctx: FileContext,
                   v: LintVisitor) -> None:
        if any(m in ctx.path for m in _CACHE_EXEMPT_PATHS):
            return
        fn = dotted_name(node.func)
        head, _, tail = fn.partition(".")
        name = fn.rsplit(".", 1)[-1]
        if name not in _CACHE_MANIP_FNS:
            return
        if head not in ("torch", "jnp", "jax", "lax", "np", "numpy"):
            return
        hits = []
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            hits.extend(self._cache_kv_operands(arg))
        if hits:
            operand = dotted_name(hits[0].value) + "." + hits[0].attr
            v.report(self.rule, node,
                     f"{fn}() re-layouts {operand} storage directly — "
                     f"with int8 KV the per-head scales must ride every "
                     f"reshape/gather/concat; route through "
                     f"models/decoder.cache_kv_map (or an ops/ helper) "
                     f"so codes and k_scale/v_scale transform together")


#: spans are context-managed (`with obs.span(...)`); the sanctioned
#: exceptions are ExitStack.enter_context(...) and the tracer module's
#: own plumbing.
_SPAN_EXEMPT_PATHS = ("obs/tracer.py",)


class SpanHygieneRule:
    """G08 — see module docstring.

    Two invariants keep the phases block a TRUE partition of wall-clock:
    (a) spans close exactly once, on the thread that opened them — which
    in Python means the ``with`` protocol (an un-entered or leaked span
    corrupts the per-thread stack and every SELF-time total above it);
    (b) phase tags come from the canonical table
    (:data:`..obs.tracer.KNOWN_PHASES`) — a typo'd phase silently forks
    a new row that ``obs report``, the bench ``phases`` block, and
    bench-diff all treat as a different phase."""

    rule = "G08"

    def __init__(self):
        self._managed_ids: set = set()

    def check_module(self, tree: ast.Module, ctx: FileContext,
                     v: LintVisitor) -> None:
        self._managed_ids = set()

    # the span calls that ARE context-managed: withitem context
    # expressions and enter_context(...) arguments, noted as the walk
    # reaches their with-statement or enter_context call (both come
    # before the span call inside them)
    def check_with(self, node, ctx: FileContext, v: LintVisitor) -> None:
        for item in node.items:
            self._managed_ids.add(id(item.context_expr))

    @staticmethod
    def _is_span_call(node: ast.Call) -> bool:
        if isinstance(node.func, ast.Attribute):
            return node.func.attr == "span"
        return isinstance(node.func, ast.Name) and node.func.id == "span"

    @staticmethod
    def _is_add_span_call(node: ast.Call) -> bool:
        fn = dotted_name(node.func)
        return fn.rsplit(".", 1)[-1] == "add_span"

    def check_call(self, node: ast.Call, ctx: FileContext,
                   v: LintVisitor) -> None:
        if any(m in ctx.path for m in _SPAN_EXEMPT_PATHS):
            return
        if dotted_name(node.func).rsplit(".", 1)[-1] == "enter_context":
            self._managed_ids.update(map(id, node.args))
        is_span = self._is_span_call(node)
        is_add = not is_span and self._is_add_span_call(node)
        if not (is_span or is_add):
            return
        if is_span and id(node) not in self._managed_ids:
            v.report(self.rule, node,
                     "tracer span must be context-managed ('with "
                     "obs.span(...)' or stack.enter_context(...)): a "
                     "span that never closes corrupts the per-thread "
                     "span stack and every phase SELF-time above it "
                     "(cross-thread timing belongs to add_span)")
        for kw in node.keywords:
            if kw.arg != "phase":
                continue
            val = kw.value
            if isinstance(val, ast.Constant) and val.value is None:
                continue
            if not (isinstance(val, ast.Constant)
                    and isinstance(val.value, str)):
                v.report(self.rule, node,
                         "span phase= must be a string literal from the "
                         "known phase table (obs/tracer.KNOWN_PHASES): a "
                         "computed phase name forks the phases block "
                         "outside the documented partition")
            elif val.value not in KNOWN_PHASES:
                v.report(self.rule, node,
                         f"unknown span phase {val.value!r}: phases come "
                         f"from obs/tracer.KNOWN_PHASES (README 'Span / "
                         f"phase names' table) — add it there first if "
                         f"this is a new pipeline stage")


def default_rules() -> List:
    """The per-file rules the port runs: G01, G02 and G05-G08 (G03 and
    G04 do not run; G09-G11 are :mod:`.threads`)."""
    return [HostSyncRule(), TensorControlFlowRule(), BroadExceptRule(),
            TelemetryDisciplineRule(), CacheScaleAwarenessRule(),
            SpanHygieneRule()]
