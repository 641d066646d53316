"""AST walking infrastructure for the port's linter.

The reference's ``lint/visitor.py`` read for PyTorch.  The linter runs
TWO passes per file.  Pass 1 (:class:`ModuleGraph`) builds a
module-level call graph — every function/method under a dotted qualname,
module import aliases resolved (``from ..models import decoder as
dmod``), edges from call sites to same-module callees — and propagates
device-region membership interprocedurally from the roots (the engine's
``launch`` pipeline closures) down to bounded depth, seeding each reached
helper with the parameters that receive tensor arguments at its device
call sites.  Pass 2 is an :class:`ast.NodeVisitor` walk that keeps a
stack of :class:`FunctionInfo` frames (graph-aware: a helper reachable
from a ``launch`` closure carries ``in_device_region`` and its seeded
params) and dispatches each node to every rule that declares a matching
``check_<nodetype>`` method.  Rules stay declarative — the PyTorch
context resolution (what is a tensor, what is a device region, what is
sanctioned) lives here, once.

Terminology the rules share:

- **device region** — a ``launch``-named closure inside a hot-path
  module, and every helper it reaches within
  :data:`INTERPROCEDURAL_DEPTH` call hops.  The engine's pipeline
  contract (``runtime/engine._run_pipelined``) is that ``launch`` only
  queues device work and ``consume`` is the sanctioned host-fetch point:
  a sync inside ``launch`` waits for every kernel queued before it and
  stalls the very pipeline the engine's depth-2 overlap builds.
- **sanctioned** — a ``consume`` closure (never a device region, and
  never reached through the graph) and a ``with
  strict.sanctioned_fetch():`` block: the places where a fetch belongs.
  ``runtime/strict.py`` arms the same contract at run time with
  ``torch.cuda.set_sync_debug_mode``.
- **tensor value** — the result of a ``torch.*`` op (but not of the
  host-structural ``torch.cuda``/``torch.backends``/``torch.device``/...
  callables), of a method on a tensor (but not its metadata:
  ``.shape``, ``.dtype``, ``.size()``, ``.numel()``, ...), of the
  engine's ``self._tensor(...)`` / ``to_device(...)``, or of the model's
  device calls (``self._dev.*`` and the port's ``models/`` and ``ops/``
  modules); a name bound from one; a helper parameter seeded with one.
  Everything else — numpy arrays, batch metadata, Python numbers — is a
  host value.
- **hot path** — runtime/engine.py + runtime/batching.py + models/ +
  ops/: the per-batch code where one stray ``.item()`` multiplies by
  every batch of a 10k-row sweep.
"""

from __future__ import annotations

import ast
import re
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from .report import Finding, parse_suppressions, suppressed

#: interprocedural propagation bound: device-region membership flows at
#: most this many call hops from a ``launch`` root.  Deep enough for the
#: real helper chains (launch -> _launch_select -> _prefill_select ->
#: prefill helper is 3 hops); a bound keeps recursive graphs terminating
#: and the findings explainable (every message names its root and depth).
INTERPROCEDURAL_DEPTH = 4

#: Path fragments marking the per-batch hot path (see module docstring).
HOT_PATH_MARKERS = (
    "runtime/engine.py",
    "runtime/batching.py",
    "/models/",
    "models/decoder.py",
    "/ops/",
)

#: Path fragments where G05 (broad except) applies: every layer that sits
#: between a device error and runtime/faults.py's OOM/transient
#: classification, the serving and observability layers included (their
#: deliberate best-effort catches carry disable annotations).  Analysis,
#: stats and viz modules keep their defensive catches — nothing there
#: handles device errors.
FAULT_PATH_MARKERS = (
    "/runtime/", "/ops/", "/models/", "/sweeps/", "/parallel/", "/native/",
    "/serve/", "/obs/", "/scoring/",
    "runtime/", "ops/", "models/", "sweeps/", "parallel/", "native/",
    "serve/", "obs/", "scoring/",
)

#: tensor attributes that are host metadata — THE shared definition (G01's
#: cast scan, G02's predicate and G07's operand walk all key on it).
METADATA_ATTRS = ("shape", "size", "dtype", "ndim", "itemsize", "device",
                  "is_cuda", "layout", "requires_grad")

#: tensor methods whose results are host values: metadata, or the syncs
#: G01 names itself (their result is already on the host)
_HOST_METHODS = frozenset({
    "size", "dim", "ndimension", "numel", "nelement", "element_size",
    "stride", "storage_offset", "is_contiguous", "is_floating_point",
    "is_complex", "data_ptr", "get_device", "item", "tolist", "numpy",
})

#: torch callables that return host structure (devices, dtypes, flags,
#: streams, generators), not tensors
_HOST_TORCH_RE = re.compile(
    r"torch\.(cuda|backends|distributed|autograd|profiler|utils|testing|"
    r"compiler|version|device|dtype|finfo|iinfo|Size|Generator|is_tensor|"
    r"is_floating_point|is_complex|is_grad_enabled|get_\w+|set_\w+|"
    r"manual_seed|no_grad|inference_mode|enable_grad|autocast)\b")

#: import-resolved module prefixes whose functions run device work and
#: return tensors: the port's model and kernel layers
_DEVICE_MODULE_PREFIXES = ("models.", "ops.")

#: the engine's host-to-device entry points
_TO_DEVICE_CALLS = frozenset({"self._tensor", "to_device",
                              "device.to_device"})

_IDENTITY_OPS = (ast.Is, ast.IsNot, ast.In, ast.NotIn)


def dotted_name(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for a Name/Attribute chain; '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def tensor_call(fn: str) -> bool:
    """True when the (import-resolved) callee ``fn`` returns a tensor."""
    if fn.startswith("torch."):
        return not _HOST_TORCH_RE.match(fn)
    return (fn.startswith(_DEVICE_MODULE_PREFIXES)
            or fn in _TO_DEVICE_CALLS or fn.startswith("self._dev."))


def tensor_value(node: ast.AST, names: Set[str],
                 resolve: Callable[[str], str] = lambda n: n) -> bool:
    """True when ``node`` evaluates to a tensor, given the ``names`` known
    to hold tensors (see the module docstring)."""
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.Attribute):
        return (node.attr not in METADATA_ATTRS
                and tensor_value(node.value, names, resolve))
    if isinstance(node, (ast.Subscript, ast.Starred)):
        return tensor_value(node.value, names, resolve)
    if isinstance(node, ast.Call):
        if tensor_call(resolve(dotted_name(node.func))):
            return True
        return (isinstance(node.func, ast.Attribute)
                and node.func.attr not in _HOST_METHODS
                and tensor_value(node.func.value, names, resolve))
    if isinstance(node, ast.BinOp):
        return (tensor_value(node.left, names, resolve)
                or tensor_value(node.right, names, resolve))
    if isinstance(node, ast.UnaryOp):
        return tensor_value(node.operand, names, resolve)
    if isinstance(node, ast.Compare):
        if all(isinstance(op, _IDENTITY_OPS) for op in node.ops):
            return False
        return any(tensor_value(n, names, resolve)
                   for n in [node.left, *node.comparators])
    if isinstance(node, ast.BoolOp):
        return any(tensor_value(n, names, resolve) for n in node.values)
    if isinstance(node, ast.IfExp):
        return (tensor_value(node.body, names, resolve)
                or tensor_value(node.orelse, names, resolve))
    if isinstance(node, (ast.Tuple, ast.List)):
        return any(tensor_value(n, names, resolve) for n in node.elts)
    return False


def _target_names(targets) -> List[str]:
    """Names an assignment binds (``sp["k"] = v`` binds none)."""
    out: List[str] = []
    for t in targets:
        if isinstance(t, ast.Name):
            out.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            out += _target_names(t.elts)
        elif isinstance(t, ast.Starred):
            out += _target_names([t.value])
    return out


def _is_sanctioned_block(node: ast.With) -> bool:
    return any(dotted_name(item.context_expr.func).rsplit(".", 1)[-1]
               == "sanctioned_fetch"
               for item in node.items
               if isinstance(item.context_expr, ast.Call))


class _FnNode:
    """One function in the module call graph (pass 1)."""

    __slots__ = ("node", "qualname", "name", "params", "is_launch",
                 "call_nodes", "calls", "assigns", "seeded",
                 "reached_depth", "reached_via", "children")

    def __init__(self, node, qualname: str):
        self.node = node
        self.qualname = qualname
        self.name = node.name
        args = node.args
        self.params: List[str] = [
            a.arg for a in (args.posonlyargs + args.args + args.kwonlyargs)]
        self.is_launch = False
        #: the body's calls (nested defs, lambdas and classes excluded)
        self.call_nodes: List[ast.Call] = []
        #: [(callee _FnNode, ast.Call)] same-module edges
        self.calls: List[Tuple["_FnNode", ast.Call]] = []
        #: (targets, value) of the body's assignments, in source order
        #: (the collector's depth-first walk visits statements in order)
        self.assigns: List[Tuple[list, ast.expr]] = []
        #: params that receive tensor args at device call sites
        self.seeded: Set[str] = set()
        self.reached_depth: Optional[int] = None  # 0 for roots
        self.reached_via: Optional[str] = None    # root qualname
        #: directly-nested function name -> _FnNode (lexical resolution)
        self.children: Dict[str, "_FnNode"] = {}


class ModuleGraph:
    """Pass 1: module-level call graph + interprocedural device regions.

    Scope is deliberately ONE module: the linter never imports code, and
    the conventions it guards (engine helpers, pipeline closures) live
    next to their callers.  Aliases are resolved for imports and for
    module-level function rebinds (``score = _score``); propagation is
    bounded by :data:`INTERPROCEDURAL_DEPTH` so recursive or cyclic call
    chains terminate with an explainable depth."""

    def __init__(self, tree: ast.Module, hot_module: bool,
                 max_depth: int = INTERPROCEDURAL_DEPTH):
        self.max_depth = max_depth
        self.functions: Dict[str, _FnNode] = {}
        self.aliases: Dict[str, str] = {}
        self._methods: Dict[str, Dict[str, _FnNode]] = {}
        self._module_fns: Dict[str, _FnNode] = {}
        self._collect_aliases(tree)
        self._collect_functions(tree, hot_module)
        self._collect_edges()
        self._propagate()

    # -- alias handling ---------------------------------------------------

    def _collect_aliases(self, tree: ast.Module) -> None:
        for node in tree.body:
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.aliases[a.asname] = a.name
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                for a in node.names:
                    if a.name == "*":
                        continue
                    full = f"{mod}.{a.name}" if mod else a.name
                    self.aliases[a.asname or a.name] = full

    def resolve(self, dotted: str) -> str:
        """Resolve the leading segment of a dotted name through the
        module's import aliases: ``np.asarray`` -> ``numpy.asarray``."""
        if not dotted:
            return dotted
        head, _, rest = dotted.partition(".")
        full = self.aliases.get(head)
        if full is None:
            return dotted
        return f"{full}.{rest}" if rest else full

    # -- function + edge collection ---------------------------------------

    def _collect_functions(self, tree: ast.Module, hot_module: bool) -> None:
        graph = self

        class Collector(ast.NodeVisitor):
            def __init__(self):
                self.qual: List[str] = []
                self.fn_stack: List[_FnNode] = []
                self.class_depth = 0

            def _function(self, node):
                qualname = ".".join(self.qual + [node.name])
                is_method = (self.class_depth > 0 and bool(self.qual)
                             and not any(self.fn_stack))
                fn = _FnNode(node, qualname)
                fn.is_launch = hot_module and node.name == "launch"
                graph.functions[qualname] = fn
                # the nearest enclosing function (a nested class's methods
                # are its children, as in the reference)
                owner = next((f for f in reversed(self.fn_stack)
                              if f is not None), None)
                if owner is not None:
                    owner.children[node.name] = fn
                elif self.class_depth == 0:
                    graph._module_fns[node.name] = fn
                if is_method:
                    graph._methods.setdefault(
                        self.qual[-1], {})[node.name] = fn
                self.qual.append(node.name)
                self.fn_stack.append(fn)
                try:
                    for child in node.body:
                        self.visit(child)
                finally:
                    self.fn_stack.pop()
                    self.qual.pop()

            visit_FunctionDef = _function
            visit_AsyncFunctionDef = _function

            def visit_ClassDef(self, node):
                self.qual.append(node.name)
                self.class_depth += 1
                # a class body's statements belong to no function's edges
                self.fn_stack.append(None)
                try:
                    for child in node.body:
                        self.visit(child)
                finally:
                    self.fn_stack.pop()
                    self.class_depth -= 1
                    self.qual.pop()

            def visit_Lambda(self, node):
                pass  # a lambda's body is no function's edges

            # the same walk collects each function's calls and
            # assignments (its body without nested defs, lambdas or
            # classes), which _collect_edges resolves
            def visit_Call(self, node):
                if self.fn_stack and self.fn_stack[-1] is not None:
                    self.fn_stack[-1].call_nodes.append(node)
                self.generic_visit(node)

            def visit_Assign(self, node):
                if self.fn_stack and self.fn_stack[-1] is not None:
                    self.fn_stack[-1].assigns.append((node.targets,
                                                      node.value))
                self.generic_visit(node)

            def visit_AugAssign(self, node):
                if self.fn_stack and self.fn_stack[-1] is not None:
                    self.fn_stack[-1].assigns.append(([node.target],
                                                      node.value))
                self.generic_visit(node)

        Collector().visit(tree)
        # module-level function rebinds: `score = _score` aliases the graph
        for node in tree.body:
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in self._module_fns):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self._module_fns.setdefault(
                            t.id, self._module_fns[node.value.id])

    def _owner_chain(self, fn: _FnNode) -> List[_FnNode]:
        """Lexically-enclosing function nodes, innermost first."""
        chain = []
        parts = fn.qualname.split(".")
        for i in range(len(parts) - 1, 0, -1):
            parent = self.functions.get(".".join(parts[:i]))
            if parent is not None:
                chain.append(parent)
        return chain

    def _resolve_call(self, fn: _FnNode, call: ast.Call
                      ) -> Optional[_FnNode]:
        func = call.func
        if isinstance(func, ast.Name):
            name = func.id
            # lexical scope chain: own nested defs, enclosing functions'
            # nested defs, then module level
            if name in fn.children:
                return fn.children[name]
            for parent in self._owner_chain(fn):
                if name in parent.children:
                    return parent.children[name]
            return self._module_fns.get(name)
        if isinstance(func, ast.Attribute):
            parts = dotted_name(func).split(".")
            if len(parts) == 2 and parts[0] in ("self", "cls"):
                # method call: the enclosing class is the first qualname
                # segment that owns a method table
                for seg in fn.qualname.split("."):
                    table = self._methods.get(seg)
                    if table and parts[1] in table:
                        return table[parts[1]]
        return None

    def _collect_edges(self) -> None:
        for fn in self.functions.values():
            for call in fn.call_nodes:
                callee = self._resolve_call(fn, call)
                if callee is not None and callee is not fn:
                    fn.calls.append((callee, call))

    def tensor_names(self, fn: _FnNode) -> Set[str]:
        """Names holding tensors in ``fn``: its seeded params plus the
        locals bound from tensor expressions, in source order."""
        names = set(fn.seeded)
        for targets, value in fn.assigns:
            if tensor_value(value, names, self.resolve):
                names.update(_target_names(targets))
        return names

    # -- propagation -------------------------------------------------------

    def _seed_callee(self, callee: _FnNode, call: ast.Call,
                     caller_tensors: Set[str]) -> bool:
        """Mark callee params receiving tensor args; True when the seed
        set grew."""
        params = callee.params
        offset = 1 if params[:1] in (["self"], ["cls"]) else 0
        grew = False
        hits = [params[i + offset] for i, arg in enumerate(call.args)
                if not isinstance(arg, ast.Starred)
                and i + offset < len(params)
                and tensor_value(arg, caller_tensors, self.resolve)]
        hits += [kw.arg for kw in call.keywords
                 if kw.arg and kw.arg in params
                 and tensor_value(kw.value, caller_tensors, self.resolve)]
        for p in hits:
            if p not in callee.seeded:
                callee.seeded.add(p)
                grew = True
        return grew

    def _propagate(self) -> None:
        for fn in self.functions.values():
            if fn.is_launch:
                fn.reached_depth = 0
                fn.reached_via = fn.qualname
        # fixpoint over (reach, seeds): both only grow and are bounded, so
        # this terminates; the depth bound caps the frontier.  A consume
        # closure is never reached: it is the sanctioned fetch point.
        changed = True
        while changed:
            changed = False
            for fn in self.functions.values():
                if fn.reached_depth is None \
                        or fn.reached_depth >= self.max_depth:
                    continue
                tensors = self.tensor_names(fn)
                for callee, call in fn.calls:
                    if callee.name == "consume" or callee.is_launch:
                        continue
                    depth = fn.reached_depth + 1
                    if callee.reached_depth is None \
                            or depth < callee.reached_depth:
                        callee.reached_depth = depth
                        callee.reached_via = fn.reached_via
                        changed = True
                    if self._seed_callee(callee, call, tensors):
                        changed = True

    def lookup(self, qualname: str) -> Optional[_FnNode]:
        return self.functions.get(qualname)


class FunctionInfo:
    """One frame of the visitor's function stack."""

    def __init__(self, node, parent: Optional["FunctionInfo"],
                 hot_module: bool, graph_node: Optional[_FnNode] = None):
        self.node = node
        self.parent = parent
        self.name = getattr(node, "name", "<lambda>")
        args = node.args
        self.params: List[str] = [
            a.arg for a in (args.posonlyargs + args.args + args.kwonlyargs)]
        # the engine pipeline contract: `launch` closures queue device
        # work and must not fetch; `consume` closures are where fetches
        # belong (see module docstring)
        self.is_launch = hot_module and self.name == "launch"
        self.is_consume = self.name == "consume" or (
            parent is not None and parent.is_consume)
        self.in_device_region = not self.is_consume and (
            self.is_launch
            or (parent is not None and parent.in_device_region))
        #: interprocedural reach: (root qualname, depth) when the module
        #: call graph proved this function is reachable from a launch root
        self.device_path: Optional[Tuple[str, int]] = None
        #: params that receive tensor args at device call sites
        self.seeded: Set[str] = set()
        if (graph_node is not None and graph_node.reached_depth
                and not self.is_launch and not self.is_consume):
            self.device_path = (graph_node.reached_via or "?",
                                graph_node.reached_depth)
            self.in_device_region = True
            self.seeded = set(graph_node.seeded)
        #: locals bound from tensor expressions
        self.tensor_locals: Set[str] = set()
        #: depth of enclosing `with strict.sanctioned_fetch():` blocks
        self.sanctioned_depth = 0

    def region_desc(self) -> str:
        """Human description of why this frame is a device region — the
        interprocedural path when the call graph supplied one."""
        if self.is_launch:
            return "a launch pipeline closure"
        if self.device_path is not None:
            via, depth = self.device_path
            return (f"a helper reachable from launch closure '{via}' "
                    f"({depth} call hop{'s' if depth != 1 else ''})")
        if self.parent is not None:
            return self.parent.region_desc()
        return "a device region"


class FileContext:
    """Per-file state shared by every rule."""

    def __init__(self, path: str, text: str):
        self.path = path.replace("\\", "/")
        self.lines = text.splitlines()
        self.suppressions = parse_suppressions(self.lines)
        self.hot_module = any(m in self.path for m in HOT_PATH_MARKERS)
        self.fault_module = any(m in self.path for m in FAULT_PATH_MARKERS)

    def source_line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""


class LintVisitor(ast.NodeVisitor):
    """Drives the rules over one parsed file.

    Rules implement any of ``check_call / check_if / check_while /
    check_ifexp / check_assert / check_with / check_excepthandler /
    check_functiondef(node, ctx, visitor)`` and append to
    ``visitor.findings`` via :meth:`report`.  Inline ``graftlint:
    disable=`` suppressions are applied here so no rule needs to know
    about them.
    """

    def __init__(self, ctx: FileContext, rules: Sequence,
                 graph: Optional[ModuleGraph] = None):
        self.ctx = ctx
        self.rules = rules
        self.graph = graph
        self.findings: List[Finding] = []
        self.stack: List[FunctionInfo] = []
        self._qual: List[str] = []

    # -- rule-facing API --------------------------------------------------

    @property
    def function(self) -> Optional[FunctionInfo]:
        return self.stack[-1] if self.stack else None

    def resolve(self, dotted: str) -> str:
        return self.graph.resolve(dotted) if self.graph else dotted

    def sanctioned(self) -> bool:
        """Inside a consume closure or a sanctioned_fetch() block."""
        frame = self.function
        return frame is not None and (frame.is_consume
                                      or frame.sanctioned_depth > 0)

    def tensor_names(self) -> Set[str]:
        """Names holding tensors here, walked up the lexical chain to the
        device-region root (closures see their parents' tensors)."""
        names: Set[str] = set()
        f = self.function
        while f is not None:
            names |= f.tensor_locals | f.seeded
            if f.is_launch or f.device_path is not None:
                break
            f = f.parent
        return names

    def is_tensor(self, node: ast.AST) -> bool:
        return tensor_value(node, self.tensor_names(), self.resolve)

    def report(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 1)
        finding = Finding(
            rule=rule, path=self.ctx.path, line=line,
            col=getattr(node, "col_offset", 0) + 1, message=message,
            code=self.ctx.source_line(line),
        )
        if not suppressed(finding, self.ctx.suppressions):
            self.findings.append(finding)

    # -- traversal --------------------------------------------------------

    def _dispatch(self, hook: str, node: ast.AST) -> None:
        for rule in self.rules:
            fn = getattr(rule, hook, None)
            if fn is not None:
                fn(node, self.ctx, self)

    def _visit_function(self, node) -> None:
        name = getattr(node, "name", None)
        graph_node = None
        if self.graph is not None and name is not None:
            graph_node = self.graph.lookup(".".join(self._qual + [name]))
        frame = FunctionInfo(node, self.function, self.ctx.hot_module,
                             graph_node=graph_node)
        self.stack.append(frame)
        if name is not None:
            self._qual.append(name)
        self._dispatch("check_functiondef", node)
        decorators = set(map(id, getattr(node, "decorator_list", ())))
        try:
            for child in ast.iter_child_nodes(node):
                if id(child) in decorators:
                    continue  # decorators belong to the ENCLOSING frame
                self.visit(child)
        finally:
            self.stack.pop()
            if name is not None:
                self._qual.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function
    visit_Lambda = _visit_function

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._qual.append(node.name)
        try:
            self.generic_visit(node)
        finally:
            self._qual.pop()

    def visit_Assign(self, node: ast.Assign) -> None:
        self._note_tensor_assignment(node.targets, node.value)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._note_tensor_assignment([node.target], node.value)
        self.generic_visit(node)

    def _note_tensor_assignment(self, targets, value) -> None:
        """Track locals bound from tensor expressions inside device
        regions, so the rules can tell device values from host ones."""
        frame = self.function
        if frame is None or not frame.in_device_region:
            return
        if self.is_tensor(value):
            frame.tensor_locals.update(_target_names(targets))

    def visit_With(self, node) -> None:
        self._dispatch("check_with", node)
        frame = self.function
        sanctioned = frame is not None and _is_sanctioned_block(node)
        if sanctioned:
            frame.sanctioned_depth += 1
        try:
            self.generic_visit(node)
        finally:
            if sanctioned:
                frame.sanctioned_depth -= 1

    visit_AsyncWith = visit_With

    def visit_While(self, node: ast.While) -> None:
        self._dispatch("check_while", node)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        self._dispatch("check_call", node)
        self.generic_visit(node)

    def visit_If(self, node: ast.If) -> None:
        self._dispatch("check_if", node)
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._dispatch("check_ifexp", node)
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._dispatch("check_assert", node)
        self.generic_visit(node)

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        self._dispatch("check_excepthandler", node)
        self.generic_visit(node)


def lint_source(path: str, text: str, rules: Sequence,
                interprocedural: bool = True,
                tree: Optional[ast.Module] = None) -> List[Finding]:
    """Run ``rules`` over one file's source; syntax errors become a single
    G00 finding instead of crashing the whole run.

    ``interprocedural=False`` drops the call graph (no device-region
    propagation into helpers), so the fixture tests can pin what the
    graph adds.  ``tree`` is ``text`` already parsed, when the caller
    has it."""
    ctx = FileContext(path, text)
    try:
        tree = tree or ast.parse(text)
    except SyntaxError as err:
        return [Finding("G00", ctx.path, err.lineno or 1,
                        (err.offset or 0) + 1,
                        f"syntax error: {err.msg}",
                        ctx.source_line(err.lineno or 1))]
    graph = ModuleGraph(tree, ctx.hot_module) if interprocedural else None
    visitor = LintVisitor(ctx, rules, graph=graph)
    for rule in rules:
        fn = getattr(rule, "check_module", None)
        if fn is not None:
            fn(tree, ctx, visitor)
    visitor.visit(tree)
    return visitor.findings
