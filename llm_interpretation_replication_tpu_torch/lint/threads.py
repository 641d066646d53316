"""Static concurrency analysis — the linter's layer 3 (rules G09-G11), a
copy of the reference's ``lint/threads.py``.

The port's serving layer is crossed by the scheduler loop, supervisor
monitor/rebuild workers, per-replica wedge watchdogs, hedge legs, the
metrics ``ThreadingHTTPServer``, ``HostPrefetcher`` tokenize threads, the
flight-recorder dump hooks and, on a mesh, the pool's slice readers and
servers.  This layer makes the three silent concurrency bug classes a
lint failure instead of a heisenbug:

- **thread-model inference** — enumerate thread entry points
  (``threading.Thread(target=...)``, ``Timer``, executor ``submit``,
  ``BaseHTTPRequestHandler`` ``do_*`` methods) and propagate
  thread-root membership through the interprocedural call graph the
  same way :mod:`.visitor` propagates device-region membership, so
  every function carries the set of threads that can execute it.
  Every PUBLIC function/method additionally carries the implicit
  ``<api>`` root (an arbitrary caller thread).
- **G09 guarded-by** — shared state (a ``self._x`` or module-global
  container reached from >= 2 distinct thread roots) must be mutated
  under the lock(s) the other access sites hold.  Guards are inferred
  from enclosing ``with self._lock:`` regions plus CALLER-held locks:
  a helper whose every resolved internal call site holds the pool lock
  is analyzed as entered with it held (the supervisor router-hook
  contract, without annotations).  Non-atomic read-modify-write and
  container mutation on never-locked shared state is flagged too.
- **G10 lock-order** — the global lock-acquisition ordering graph
  (``serve/``, ``obs/``, ``runtime/``, ``utils/``): an edge A->B for
  every site acquiring B (directly or transitively through resolved
  calls) while holding A.  Any cycle is a potential deadlock and
  fails.  ``Condition(existing_lock)`` aliases to the wrapped lock;
  RLock self-edges are reentrant and exempt.
- **G11 blocking-under-lock** — ``time.sleep``, ``block_until_ready``,
  ``Future.result``, thread ``join``, network calls (directly or
  transitively) while holding a CONTENDED lock (one acquired from >= 2
  thread roots).  ``cond.wait()`` while holding exactly that condition
  is the sanctioned idiom (it releases) and is exempt, as is
  ``result(timeout=0)`` on a completed future.

The analysis is a WHOLE-TREE pass (unlike the per-file G01-G08 walk):
:func:`collect_thread_findings` takes every file in the lint target set
at once, because thread roots in ``serve/`` reach shared state in
``utils/telemetry.py`` only through cross-module call edges.  A partial
target set (``lint --diff``) under-approximates — fewer findings, never
spurious ones.

Approximations (this is an ADVISORY-STATIC analyzer; the runtime twin
is ``runtime/strict.py``): method calls resolve through imports,
``self``, lexical scope, and a unique-method-name heuristic — an
ambiguous name contributes no edge (under-approximation); caller-held
inference trusts in-tree call sites; dynamic dispatch, lambdas, and
locks passed as arguments are invisible.  Findings ride the standard
fingerprint/suppression/baseline machinery — suppress a deliberate
pattern inline with ``# graftlint: disable=G09 <reason>``.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Set, Tuple

from .report import Finding, parse_suppressions, suppressed
from .visitor import dotted_name

#: the implicit thread root carried by every public function/method:
#: "some caller thread we do not control".  Counts as ONE root when
#: deciding shared-ness, so purely-internal single-thread state stays
#: quiet until a second in-tree thread actually reaches it.
API_ROOT = "<api>"

#: fixpoint bounds — mirrors visitor.INTERPROCEDURAL_DEPTH's philosophy:
#: enough hops for every real chain in this repo, bounded for O(n).
HELD_ROUNDS = 4
TRANS_DEPTH = 4

_LOCK_FACTORIES = {
    "threading.Lock": "lock", "threading.RLock": "rlock",
    "threading.Condition": "condition",
    "Lock": "lock", "RLock": "rlock", "Condition": "condition",
}
_THREAD_FACTORIES = {"threading.Thread", "Thread"}
_TIMER_FACTORIES = {"threading.Timer", "Timer"}
_HTTP_HANDLER_BASES = {"BaseHTTPRequestHandler", "SimpleHTTPRequestHandler"}

#: container constructors whose module-level result is mutable shared
#: state (the telemetry registries are exactly this shape)
_CONTAINER_FACTORIES = {
    "list", "dict", "set", "deque", "defaultdict", "OrderedDict",
    "Counter", "collections.deque", "collections.defaultdict",
    "collections.OrderedDict", "collections.Counter",
}

#: method names that mutate their receiver in place
_MUTATING_METHODS = frozenset({
    "append", "extend", "insert", "remove", "pop", "clear", "update",
    "add", "discard", "setdefault", "popitem", "appendleft", "popleft",
    "sort", "reverse",
})

#: self-synchronizing primitives: attributes/globals built from these
#: factories are exempt from G09 (an ``Event.set()``/``Queue.put()`` is
#: its own synchronization) and their methods never resolve through the
#: unique-method-name heuristic (``self._event.wait`` is threading's
#: wait, not some in-tree method that happens to share the name).
_SYNC_FACTORIES = {"threading.Event", "Event", "queue.Queue", "Queue",
                   "queue.SimpleQueue", "SimpleQueue", "threading.local",
                   "threading.Semaphore", "Semaphore",
                   "threading.BoundedSemaphore", "threading.Barrier"}

#: method names too generic for the unique-method-name heuristic: they
#: shadow stdlib synchronization/container methods, so "exactly one
#: in-tree class defines it" is evidence of a COLLISION, not identity.
_GENERIC_METHODS = frozenset({
    "wait", "set", "clear", "get", "put", "join", "start", "acquire",
    "release", "notify", "notify_all", "items", "keys", "values",
    "update", "read", "write", "flush", "send", "recv", "close",
})

#: blocking operations (G11).  Full dotted names match exactly;
#: attribute suffixes match the last component of a dotted callee.
_BLOCKING_FULL = {"time.sleep", "subprocess.run", "subprocess.check_output",
                  "subprocess.check_call"}
_BLOCKING_SUFFIX = {"result", "join", "wait", "wait_for",
                    "block_until_ready", "urlopen", "communicate"}
_BLOCKING_PREFIX = ("requests.",)
#: dotted prefixes never treated as blocking even on a suffix match
#: (``os.path.join`` is not a thread join)
_BENIGN_PREFIX = ("os.", "posixpath.", "ntpath.", "np.", "jnp.", "json.",
                  "shlex.", "itertools.")

#: API-root dunders: entry points an outside caller invokes directly
_API_DUNDERS = {"__init__", "__call__", "__enter__", "__exit__",
                "__iter__", "__next__", "__len__", "__del__"}


def _timeout_zero(call: ast.Call) -> bool:
    """True when the call passes a literal zero timeout (first
    positional or ``timeout=`` keyword) — explicitly non-blocking."""
    if call.args and isinstance(call.args[0], ast.Constant) \
            and call.args[0].value == 0:
        return True
    return any(kw.arg == "timeout" and isinstance(kw.value, ast.Constant)
               and kw.value.value == 0 for kw in call.keywords)


def _module_name(path: str) -> str:
    mod = path[:-3] if path.endswith(".py") else path
    mod = mod.replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


def _short_lock(key: str) -> str:
    """Display form of a lock key: ``serve.pool:EnginePool._lock`` ->
    ``pool.EnginePool._lock`` (enough to find it, short enough to read)."""
    mod, _, rest = key.partition(":")
    return f"{mod.rsplit('.', 1)[-1]}.{rest}" if rest else key


class _Fn:
    """One function/method/nested def in the analyzed tree."""

    __slots__ = ("module", "qualname", "name", "cls", "node", "parent",
                 "local_defs", "global_decls", "local_stores", "is_api",
                 "roots", "entry_held", "spawn_target", "blocking",
                 "acquires")

    def __init__(self, module: str, qualname: str, cls: Optional[str],
                 node: ast.AST, parent: Optional["_Fn"]):
        self.module = module
        self.qualname = qualname
        self.name = qualname.rsplit(".", 1)[-1]
        self.cls = cls
        self.node = node
        self.parent = parent
        self.local_defs: Dict[str, "_Fn"] = {}
        self.global_decls: Set[str] = set()
        self.local_stores: Set[str] = set()
        self.is_api = False
        #: root id -> (depth, via-qualname) — minimal-hop provenance
        self.roots: Dict[str, Tuple[int, str]] = {}
        self.entry_held: FrozenSet[str] = frozenset()
        self.spawn_target = False   # used as Thread target / submit fn
        #: non-exempt direct blocking sites: (dotted, lineno)
        self.blocking: List[Tuple[str, int]] = []
        #: canonical locks this fn acquires directly (with-statements)
        self.acquires: Set[str] = set()

    @property
    def key(self) -> Tuple[str, str]:
        return (self.module, self.qualname)


class _Event:
    """One collected body event, with the LEXICAL held-lock set (the
    entry-held contribution is folded in later, after the caller-held
    fixpoint)."""

    __slots__ = ("kind", "fn", "node", "held", "target", "extra")

    def __init__(self, kind: str, fn: _Fn, node: ast.AST,
                 held: FrozenSet[str], target, extra=None):
        self.kind = kind      # "acq" | "call" | "access"
        self.fn = fn
        self.node = node
        self.held = held
        self.target = target  # acq: guard id; call: dotted; access: key
        self.extra = extra    # call: ast.Call; access: access kind


class _Module:
    __slots__ = ("path", "mod", "tree", "lines", "classes", "bases",
                 "functions", "imports", "globals_mut", "pkg",
                 "suppressions")

    def __init__(self, path: str, mod: str, tree: ast.Module,
                 lines: List[str]):
        self.path = path
        self.mod = mod
        self.tree = tree
        self.lines = lines
        self.suppressions = parse_suppressions(lines)
        #: class name -> {method name -> _Fn}
        self.classes: Dict[str, Dict[str, _Fn]] = {}
        #: class name -> base-name strings
        self.bases: Dict[str, List[str]] = {}
        #: qualname -> _Fn (every def, incl. methods and nested)
        self.functions: Dict[str, _Fn] = {}
        #: local name -> (target module dotted, member name | None)
        self.imports: Dict[str, Tuple[str, Optional[str]]] = {}
        #: module-level mutable-container globals
        self.globals_mut: Set[str] = set()
        self.pkg = mod.rsplit(".", 1)[0] if "." in mod else ""


class ThreadModel:
    """The whole-tree concurrency model: thread roots per function, the
    lock registry (with Condition aliasing), guard sets per access, the
    lock-order graph, and the G09/G10/G11 findings derived from them.

    ``tests/test_torch_lint.py`` asserts :meth:`lock_cycles` is empty on
    the real tree — the deadlock-freedom pin the supervisor/pool/queue
    triangle is held to."""

    def __init__(self, file_texts: Mapping[str, str],
                 trees: Optional[Mapping[str, ast.Module]] = None):
        self.modules: Dict[str, _Module] = {}          # dotted -> module
        self._by_path: Dict[str, _Module] = {}
        self.lock_kinds: Dict[str, str] = {}           # key -> kind
        self.sync_keys: Set[str] = set()               # Event/Queue attrs
        self._lock_alias: Dict[str, str] = {}          # condition -> wrapped
        self._locks_by_attr: Dict[str, List[str]] = {}
        self._methods_by_name: Dict[str, List[_Fn]] = {}
        self.root_labels: Dict[str, str] = {API_ROOT: "an API caller thread"}
        self._events: List[_Event] = []
        self._spawns: List[Tuple[_Fn, ast.AST, str]] = []  # (target, site, root id)
        #: (held canonical, acquired canonical) -> (path, line, descr)
        self.lock_edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
        #: per-fn call events (the transitive queries walk these)
        self._calls_by_fn: Dict[Tuple[str, str], List[_Event]] = {}
        self._parse(file_texts, trees or {})
        self._collect()
        for ev in self._events:
            if ev.kind == "call":
                self._calls_by_fn.setdefault(ev.fn.key, []).append(ev)
        self._propagate_roots()
        self._propagate_entry_held()
        self._fold_entry_held()
        self._collect_blocking()
        self._build_lock_edges()

    # -- pass A: parse + registries -------------------------------------

    def _parse(self, file_texts: Mapping[str, str],
               trees: Mapping[str, ast.Module]) -> None:
        for path in sorted(file_texts):
            text = file_texts[path]
            tree = trees.get(path)
            try:
                tree = tree or ast.parse(text)
            except SyntaxError:
                continue    # the per-file walk already reported G00
            m = _Module(path, _module_name(path), tree, text.splitlines())
            self.modules[m.mod] = m
            self._by_path[path] = m
        for m in self.modules.values():
            self._collect_imports(m)
            self._collect_defs(m)
        for m in self.modules.values():
            self._collect_locks_and_globals(m)
        # canonicalize condition aliases transitively (Condition(lock))
        for key in list(self._lock_alias):
            seen = {key}
            tgt = self._lock_alias[key]
            while tgt in self._lock_alias and tgt not in seen:
                seen.add(tgt)
                tgt = self._lock_alias[tgt]
            self._lock_alias[key] = tgt
        for fns in self._methods_by_name.values():
            fns.sort(key=lambda f: (f.module, f.qualname))

    def _collect_imports(self, m: _Module) -> None:
        for node in m.tree.body:
            if isinstance(node, ast.Import):
                for a in node.names:
                    local = a.asname or a.name.split(".")[0]
                    target = a.name if a.asname else a.name.split(".")[0]
                    m.imports[local] = (target, None)
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    parts = m.mod.split(".")
                    # a module's package is its dotted name minus the
                    # leaf (packages themselves keep the full name)
                    if not m.path.endswith("__init__.py"):
                        parts = parts[:-1]
                    parts = parts[: len(parts) - (node.level - 1)]
                    base = ".".join(parts + ([base] if base else []))
                for a in node.names:
                    local = a.asname or a.name
                    full = f"{base}.{a.name}" if base else a.name
                    if full in self.modules or a.name == "*":
                        m.imports[local] = (full, None)   # module alias
                    else:
                        m.imports[local] = (base, a.name)

    def _collect_defs(self, m: _Module) -> None:
        def walk(body, cls: Optional[str], parent: Optional[_Fn],
                 prefix: str) -> None:
            for node in body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{prefix}{node.name}"
                    fn = _Fn(m.mod, qual, cls, node, parent)
                    m.functions[qual] = fn
                    if parent is not None:
                        parent.local_defs[node.name] = fn
                    elif cls is not None:
                        m.classes.setdefault(cls, {})[node.name] = fn
                        self._methods_by_name.setdefault(
                            node.name, []).append(fn)
                    fn.is_api = self._is_api(fn)
                    walk(node.body, cls, fn, f"{qual}.")
                    # after the nested defs: their global declarations
                    # count as this function's too
                    self._scan_local_stores(fn)
                elif isinstance(node, ast.ClassDef) and parent is None:
                    m.classes.setdefault(node.name, {})
                    m.bases[node.name] = [
                        b for b in (dotted_name(x) for x in node.bases) if b]
                    walk(node.body, node.name, None, f"{node.name}.")

        walk(m.tree.body, None, None, "")

    @staticmethod
    def _scan_local_stores(fn: _Fn) -> None:
        """``fn.global_decls`` (every ``global`` statement in its body,
        nested defs included) and ``fn.local_stores`` (the names its own
        body binds, nested defs excluded), in one walk that reuses the
        nested defs' declarations."""
        nested = {id(d.node): d for d in fn.local_defs.values()}
        stores: Set[str] = set()
        # manual stack walk: ast.walk would descend into NESTED defs and
        # pollute this fn's local-store set with theirs
        stack: List[ast.AST] = list(ast.iter_child_nodes(fn.node))
        while stack:
            sub = stack.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner = nested.get(id(sub))
                if inner is not None:
                    fn.global_decls.update(inner.global_decls)
                else:   # a def the model does not hold (a nested class's)
                    fn.global_decls.update(
                        n for g in ast.walk(sub) if isinstance(g, ast.Global)
                        for n in g.names)
                continue
            if isinstance(sub, ast.Lambda):
                continue
            if isinstance(sub, ast.Global):
                fn.global_decls.update(sub.names)
            elif isinstance(sub, ast.Name) and isinstance(
                    sub.ctx, (ast.Store, ast.Del)):
                stores.add(sub.id)
            stack.extend(ast.iter_child_nodes(sub))
        fn.local_stores = stores - fn.global_decls

    @staticmethod
    def _is_api(fn: _Fn) -> bool:
        if fn.parent is not None:       # nested defs are never API
            return False
        if fn.cls is None:
            return not fn.name.startswith("_")
        if fn.cls.startswith("_"):
            return False
        return (not fn.name.startswith("_")) or fn.name in _API_DUNDERS

    def _collect_locks_and_globals(self, m: _Module) -> None:
        # module-level: X = threading.Lock() / mutable containers
        for node in m.tree.body:
            targets: List[ast.expr] = []
            value = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            if value is None:
                continue
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                self._maybe_register_lock(m, None, t.id, value)
                if self._is_container_value(value):
                    m.globals_mut.add(t.id)
        # any global declared+stored in a function is mutable state too
        for fn in m.functions.values():
            m.globals_mut.update(fn.global_decls)
        # instance locks: self._x = threading.Lock() in any method
        for fn in m.functions.values():
            if fn.cls is None:
                continue
            for sub in ast.walk(fn.node):
                targets, value = [], None
                if isinstance(sub, ast.Assign):
                    targets, value = sub.targets, sub.value
                elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
                    targets, value = [sub.target], sub.value
                if value is None:
                    continue
                for t in targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        self._maybe_register_lock(m, fn.cls, t.attr, value)

    @staticmethod
    def _is_container_value(value: ast.expr) -> bool:
        if isinstance(value, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                              ast.DictComp, ast.SetComp)):
            return True
        if isinstance(value, ast.Call):
            name = dotted_name(value.func)
            return name in _CONTAINER_FACTORIES
        return False

    def _maybe_register_lock(self, m: _Module, cls: Optional[str],
                             attr: str, value: ast.expr) -> None:
        if not isinstance(value, ast.Call):
            return
        factory = dotted_name(value.func)
        key = f"{m.mod}:{cls}.{attr}" if cls else f"{m.mod}:{attr}"
        if factory in _SYNC_FACTORIES:
            self.sync_keys.add(key)
            return
        kind = _LOCK_FACTORIES.get(factory or "")
        if kind is None:
            return
        self.lock_kinds[key] = kind
        self._locks_by_attr.setdefault(attr, []).append(key)
        if kind == "condition" and value.args:
            wrapped = dotted_name(value.args[0])
            if wrapped and wrapped.startswith("self.") and cls:
                self._lock_alias[key] = f"{m.mod}:{cls}.{wrapped[5:]}"
            elif wrapped and "." not in wrapped:
                self._lock_alias[key] = f"{m.mod}:{wrapped}"

    # -- lock / guard resolution ----------------------------------------

    def canon(self, key: str) -> str:
        return self._lock_alias.get(key, key)

    def canon_kind(self, key: str) -> Optional[str]:
        return self.lock_kinds.get(self.canon(key))

    def _resolve_lockref(self, dotted: Optional[str],
                         fn: _Fn) -> Optional[str]:
        """Dotted lock expression -> guard id.  Canonical lock keys
        participate in G10/G11; an unresolvable expression still gets a
        TEXTUAL guard id (``?module:expr``) so G09 guard-consistency
        sees it, but it contributes no ordering edges."""
        if not dotted:
            return None
        m = self.modules[fn.module]
        parts = dotted.split(".")
        if parts[0] == "self" and len(parts) == 2 and fn.cls:
            key = f"{fn.module}:{fn.cls}.{parts[1]}"
            if key in self.lock_kinds or key in self._lock_alias:
                return self.canon(key)
        if len(parts) == 1:
            key = f"{fn.module}:{parts[0]}"
            if key in self.lock_kinds:
                return self.canon(key)
            imp = m.imports.get(parts[0])
            if imp and imp[1]:
                key = f"{imp[0]}:{imp[1]}"
                if key in self.lock_kinds:
                    return self.canon(key)
            return None                 # a plain name is rarely a lock
        # <anything>._attr: unique-attribute heuristic across the tree
        cands = {self.canon(k) for k in self._locks_by_attr.get(parts[-1], ())}
        if len(cands) == 1:
            return next(iter(cands))
        if self._looks_locky(parts[-1]) or cands:
            return f"?{fn.module}:{dotted}"
        return None

    @staticmethod
    def _looks_locky(attr: str) -> bool:
        low = attr.lower()
        return any(s in low for s in ("lock", "cond", "wake", "mutex"))

    # -- pass B: body events --------------------------------------------

    def _collect(self) -> None:
        for m in self.modules.values():
            for fn in m.functions.values():
                body = getattr(fn.node, "body", [])
                self._walk_stmts(body, fn, frozenset())
        # HTTP handler do_* methods are thread roots (ThreadingHTTPServer
        # runs each request on its own thread)
        for m in self.modules.values():
            for cls, bases in m.bases.items():
                if not any(b.rsplit(".", 1)[-1] in _HTTP_HANDLER_BASES
                           for b in bases):
                    continue
                for name, fn in m.classes.get(cls, {}).items():
                    if name.startswith("do_"):
                        rid = f"{m.mod}:{fn.qualname}"
                        fn.roots.setdefault(rid, (0, fn.qualname))
                        fn.spawn_target = True
                        self.root_labels.setdefault(
                            rid, f"HTTP handler thread {fn.qualname}")

    def _walk_stmts(self, body: Sequence[ast.stmt], fn: _Fn,
                    held: FrozenSet[str]) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue    # nested defs run later, NOT under this lock
            if isinstance(node, ast.With):
                inner = held
                for item in node.items:
                    guard = self._resolve_lockref(
                        dotted_name(item.context_expr), fn)
                    self._walk_exprs([item.context_expr], fn, held)
                    if guard is not None:
                        self._events.append(
                            _Event("acq", fn, item.context_expr, inner,
                                   guard))
                        if not guard.startswith("?"):
                            fn.acquires.add(guard)
                        inner = inner | {guard}
                self._walk_stmts(node.body, fn, inner)
                continue
            for field in ("value", "test", "iter", "exc", "msg"):
                sub = getattr(node, field, None)
                if isinstance(sub, ast.expr):
                    self._walk_exprs([sub], fn, held)
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                self._handle_store(node, fn, held)
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, ast.Subscript):
                        key = self._state_key(t.value, fn)
                        if key:
                            self._events.append(
                                _Event("access", fn, node, held, key, "del"))
                        self._walk_exprs([t.slice], fn, held)
            for sub_body in ("body", "orelse", "finalbody"):
                sub = getattr(node, sub_body, None)
                if isinstance(sub, list) and not isinstance(node, ast.With):
                    self._walk_stmts([s for s in sub
                                      if isinstance(s, ast.stmt)], fn, held)
            for handler in getattr(node, "handlers", []) or []:
                self._walk_stmts(handler.body, fn, held)

    def _handle_store(self, node: ast.stmt, fn: _Fn,
                      held: FrozenSet[str]) -> None:
        if isinstance(node, ast.AugAssign):
            targets = [node.target]
            kinds = ["aug"]
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target] if node.value is not None else []
            kinds = ["store"]
        else:
            targets = list(node.targets)
            kinds = ["store"] * len(targets)
        value = getattr(node, "value", None)
        for t, kind in zip(targets, kinds):
            key = None
            if isinstance(t, (ast.Attribute, ast.Name)):
                key = self._state_key(t, fn)
            elif isinstance(t, ast.Subscript):
                key = self._state_key(t.value, fn)
                kind = "subscript"
                self._walk_exprs([t.slice], fn, held)
            if key is None:
                continue
            # a rebind whose RHS reads the same slot is a read-modify-
            # write in disguise (self.n = self.n + 1)
            if kind == "store" and value is not None:
                target_txt = dotted_name(t) if not isinstance(
                    t, ast.Subscript) else None
                if target_txt and any(
                        dotted_name(s) == target_txt
                        for s in ast.walk(value)
                        if isinstance(s, (ast.Attribute, ast.Name))):
                    kind = "aug"
            self._events.append(_Event("access", fn, node, held, key, kind))

    def _state_key(self, node: ast.expr, fn: _Fn) -> Optional[str]:
        """`self.X` -> ``module:Class.X``; a declared-global or
        module-container bare name -> ``module:X``; else None."""
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self" and fn.cls):
            return f"{fn.module}:{fn.cls}.{node.attr}"
        if isinstance(node, ast.Name):
            name = node.id
            if name in fn.local_stores and name not in fn.global_decls:
                return None
            m = self.modules[fn.module]
            if name in m.globals_mut or name in fn.global_decls:
                return f"{fn.module}:{name}"
        return None

    def _walk_exprs(self, exprs: Sequence[ast.expr], fn: _Fn,
                    held: FrozenSet[str]) -> None:
        stack = list(exprs)
        while stack:
            node = stack.pop()
            if isinstance(node, ast.Lambda):
                continue    # runs later; its body is not under this lock
            if isinstance(node, ast.Call):
                self._handle_call(node, fn, held)
            elif (isinstance(node, ast.Attribute)
                  and isinstance(node.ctx, ast.Load)):
                key = self._state_key(node, fn)
                if key:
                    self._events.append(
                        _Event("access", fn, node, held, key, "read"))
            elif (isinstance(node, ast.Name)
                  and isinstance(node.ctx, ast.Load)):
                key = self._state_key(node, fn)
                if key:
                    self._events.append(
                        _Event("access", fn, node, held, key, "read"))
            stack.extend(ast.iter_child_nodes(node))

    def _handle_call(self, node: ast.Call, fn: _Fn,
                     held: FrozenSet[str]) -> None:
        callee = dotted_name(node.func)
        if callee:
            self._events.append(_Event("call", fn, node, held, callee, node))
            base = callee.rsplit(".", 1)[0] if "." in callee else None
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _MUTATING_METHODS and base):
                key = self._state_key(node.func.value, fn)
                if key:
                    self._events.append(
                        _Event("access", fn, node, held, key, "mutcall"))
            self._maybe_spawn(node, callee, fn)

    def _maybe_spawn(self, node: ast.Call, callee: str, fn: _Fn) -> None:
        target_expr: Optional[ast.expr] = None
        if callee in _THREAD_FACTORIES:
            for kw in node.keywords:
                if kw.arg == "target":
                    target_expr = kw.value
        elif callee in _TIMER_FACTORIES and len(node.args) >= 2:
            target_expr = node.args[1]
        elif callee.endswith(".submit") and node.args:
            cand = node.args[0]
            if isinstance(cand, (ast.Name, ast.Attribute)):
                target_expr = cand
        if target_expr is None:
            return
        target = self._resolve_callee(dotted_name(target_expr), fn)
        if target is None:
            return
        rid = f"{target.module}:{target.qualname}"
        label = None
        for kw in node.keywords:
            if kw.arg == "name" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                label = f"thread '{kw.value.value}'"
        target.roots.setdefault(rid, (0, target.qualname))
        target.spawn_target = True
        self.root_labels.setdefault(
            rid, label or f"thread target {target.qualname}")
        self._spawns.append((target, node, rid))

    # -- call resolution ------------------------------------------------

    def _resolve_callee(self, dotted: Optional[str],
                        fn: _Fn) -> Optional[_Fn]:
        if not dotted:
            return None
        m = self.modules[fn.module]
        parts = dotted.split(".")
        if len(parts) == 1:
            name = parts[0]
            scope: Optional[_Fn] = fn
            while scope is not None:    # lexical nesting, innermost first
                if name in scope.local_defs:
                    return scope.local_defs[name]
                scope = scope.parent
            if name in m.functions and m.functions[name].cls is None:
                return m.functions[name]
            if name in m.classes and "__init__" in m.classes[name]:
                return m.classes[name]["__init__"]
            imp = m.imports.get(name)
            if imp and imp[1] and imp[0] in self.modules:
                return self._module_member(self.modules[imp[0]], imp[1])
            return None
        if parts[0] == "self" and len(parts) == 2 and fn.cls:
            return m.classes.get(fn.cls, {}).get(parts[1])
        if len(parts) == 2:
            imp = m.imports.get(parts[0])
            if imp and imp[1] is None and imp[0] in self.modules:
                return self._module_member(self.modules[imp[0]], parts[1])
        # <expr>.method: unique-method-name heuristic — exactly one
        # class in the analyzed tree defines it, or no edge at all.
        # Generic stdlib names never resolve this way (`._event.wait`
        # is threading's wait even if one in-tree class defines a
        # `wait`), and neither do methods of known lock/sync receivers.
        if parts[-1] in _GENERIC_METHODS:
            return None
        base = ".".join(parts[:-1])
        if self._resolve_lockref(base, fn) is not None:
            return None
        if parts[0] == "self" and len(parts) == 3 and fn.cls \
                and f"{fn.module}:{fn.cls}.{parts[1]}" in self.sync_keys:
            return None
        cands = self._methods_by_name.get(parts[-1], [])
        if len(cands) == 1:
            return cands[0]
        return None

    @staticmethod
    def _module_member(m: _Module, name: str) -> Optional[_Fn]:
        if name in m.functions and m.functions[name].cls is None:
            return m.functions[name]
        if name in m.classes and "__init__" in m.classes[name]:
            return m.classes[name]["__init__"]
        return None

    def _external_dotted(self, dotted: str, fn: _Fn) -> str:
        """Resolve the module half of a dotted callee through imports so
        ``sleep`` imported from ``time`` matches ``time.sleep``."""
        m = self.modules[fn.module]
        parts = dotted.split(".")
        imp = m.imports.get(parts[0])
        if imp and imp[0] not in self.modules:
            if imp[1]:      # from time import sleep
                return ".".join([imp[0], imp[1]] + parts[1:])
            return ".".join([imp[0]] + parts[1:])
        return dotted

    # -- fixpoints ------------------------------------------------------

    def _propagate_roots(self) -> None:
        for m in self.modules.values():
            for fn in m.functions.values():
                if fn.is_api:
                    fn.roots.setdefault(API_ROOT, (0, fn.qualname))
        edges: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}
        for ev in self._events:
            if ev.kind != "call":
                continue
            target = self._resolve_callee(ev.target, ev.fn)
            if target is not None and target.key != ev.fn.key:
                edges.setdefault(ev.fn.key, set()).add(target.key)
        work = [fn for m in self.modules.values()
                for fn in m.functions.values() if fn.roots]
        while work:
            fn = work.pop()
            for tkey in edges.get(fn.key, ()):
                callee = self.modules[tkey[0]].functions[tkey[1]]
                changed = False
                for rid, (depth, _via) in fn.roots.items():
                    nxt = (depth + 1, fn.qualname)
                    if rid not in callee.roots \
                            or callee.roots[rid][0] > depth + 1:
                        callee.roots[rid] = nxt
                        changed = True
                if changed:
                    work.append(callee)

    def _call_sites_by_target(self) -> Dict[Tuple[str, str], List[_Event]]:
        out: Dict[Tuple[str, str], List[_Event]] = {}
        for ev in self._events:
            if ev.kind != "call":
                continue
            target = self._resolve_callee(ev.target, ev.fn)
            if target is not None and target.key != ev.fn.key:
                out.setdefault(target.key, []).append(ev)
        return out

    def _propagate_entry_held(self) -> None:
        """entry_held(f) = ∩ over resolved in-tree call sites of the
        locks held there (lexical ∪ caller's entry_held).  Thread spawn
        targets start fresh on their own thread: forced empty."""
        sites = self._call_sites_by_target()
        for _ in range(HELD_ROUNDS):
            changed = False
            for m in self.modules.values():
                for fn in m.functions.values():
                    if fn.spawn_target or fn.key not in sites:
                        continue
                    acc: Optional[FrozenSet[str]] = None
                    for ev in sites[fn.key]:
                        h = ev.held | ev.fn.entry_held
                        acc = h if acc is None else (acc & h)
                    acc = acc or frozenset()
                    if acc != fn.entry_held:
                        fn.entry_held = acc
                        changed = True
            if not changed:
                break

    def _fold_entry_held(self) -> None:
        # entry-held locks fold into every event's held set, but NOT
        # into fn.acquires: the caller acquired them — crediting them to
        # the callee would fabricate reversed lock-order edges
        for ev in self._events:
            ev.held = ev.held | ev.fn.entry_held

    # -- blocking + lock edges ------------------------------------------

    def _blocking_reason(self, ev: _Event) -> Optional[str]:
        dotted = self._external_dotted(ev.target, ev.fn)
        if dotted.startswith(_BENIGN_PREFIX):
            return None
        leaf = dotted.rsplit(".", 1)[-1]
        hit = (dotted in _BLOCKING_FULL
               or dotted.startswith(_BLOCKING_PREFIX)
               or leaf in _BLOCKING_SUFFIX)
        if not hit:
            return None
        call: ast.Call = ev.extra
        if leaf in ("result", "wait", "join", "exception") \
                and _timeout_zero(call):
            return None     # result(timeout=0)/wait(0) never blocks
        if leaf in ("wait", "wait_for") and "." in ev.target:
            base = ev.target.rsplit(".", 1)[0]
            guard = self._resolve_lockref(base, ev.fn)
            if guard is not None and guard in ev.held:
                return None     # cond.wait() RELEASES the held condition
        return dotted

    def _collect_blocking(self) -> None:
        for ev in self._events:
            if ev.kind != "call":
                continue
            # an inline `# graftlint: disable=G11 reason` at the
            # blocking site declares it non-blocking for the MODEL too,
            # so transitive findings at its callers clear with it
            supp = self.modules[ev.fn.module].suppressions
            if "G11" in supp.get(ev.node.lineno, ()):
                continue
            reason = self._blocking_reason(ev)
            if reason and self._resolve_callee(ev.target, ev.fn) is None:
                ev.fn.blocking.append((reason, ev.node.lineno))

    def transitive_blocking(self, fn: _Fn, depth: int = TRANS_DEPTH,
                            _seen=None) -> Optional[Tuple[str, str]]:
        """First (blocking op, via-chain) reachable from ``fn``."""
        if _seen is None:
            _seen = set()
        if fn.key in _seen or depth < 0:
            return None
        _seen.add(fn.key)
        if fn.blocking:
            return (fn.blocking[0][0], fn.qualname)
        for ev in self._calls_by_fn.get(fn.key, ()):
            if _timeout_zero(ev.extra):
                continue    # an explicit timeout=0 hop never blocks
            target = self._resolve_callee(ev.target, ev.fn)
            if target is None or target.spawn_target:
                continue
            found = self.transitive_blocking(target, depth - 1, _seen)
            if found:
                return (found[0], f"{fn.qualname} -> {found[1]}")
        return None

    def _transitive_acquires(self, fn: _Fn, depth: int = TRANS_DEPTH,
                             _seen=None) -> Set[str]:
        if _seen is None:
            _seen = set()
        if fn.key in _seen or depth < 0:
            return set()
        _seen.add(fn.key)
        out = set(fn.acquires)
        for ev in self._calls_by_fn.get(fn.key, ()):
            target = self._resolve_callee(ev.target, ev.fn)
            if target is not None and not target.spawn_target:
                out |= self._transitive_acquires(target, depth - 1, _seen)
        return out

    def _build_lock_edges(self) -> None:
        def add_edge(held: str, acq: str, ev: _Event, descr: str) -> None:
            if held.startswith("?") or acq.startswith("?"):
                return
            if held == acq:
                return      # self-edges handled separately (relock)
            edge = (held, acq)
            old = self.lock_edges.get(edge)
            path = self.modules[ev.fn.module].path
            new = (path, ev.node.lineno, descr)
            if old is None or (new[0], new[1]) < (old[0], old[1]):
                self.lock_edges[edge] = new

        for ev in self._events:
            if ev.kind == "acq":
                for h in ev.held:
                    add_edge(h, ev.target, ev,
                             f"{ev.fn.qualname} acquires "
                             f"{_short_lock(ev.target)} while holding "
                             f"{_short_lock(h)}")
            elif ev.kind == "call" and ev.held:
                target = self._resolve_callee(ev.target, ev.fn)
                if target is None or target.spawn_target:
                    continue
                for acq in self._transitive_acquires(target):
                    for h in ev.held:
                        add_edge(h, acq, ev,
                                 f"{ev.fn.qualname} -> {target.qualname} "
                                 f"acquires {_short_lock(acq)} while "
                                 f"holding {_short_lock(h)}")

    # -- public queries --------------------------------------------------

    def roots_of(self, module: str, qualname: str) -> Set[str]:
        m = self.modules.get(module)
        fn = m.functions.get(qualname) if m else None
        return set(fn.roots) if fn else set()

    def lock_roots(self, key: str) -> Set[str]:
        """Thread roots that ACQUIRE ``key`` (the with-statement sites);
        a lock is contended when this has >= 2 members."""
        out: Set[str] = set()
        for ev in self._events:
            if ev.kind == "acq" and ev.target == key:
                out |= set(ev.fn.roots)
        return out

    def lock_cycles(self) -> List[List[str]]:
        """Cycles in the lock-order graph (Tarjan SCCs of size > 1,
        plus non-reentrant self-loops), each as the ordered key list."""
        graph: Dict[str, Set[str]] = {}
        for (a, b) in self.lock_edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: Set[str] = set()
        stack: List[str] = []
        sccs: List[List[str]] = []
        counter = [0]

        def strongconnect(v: str) -> None:
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            for w in sorted(graph.get(v, ())):
                if w not in index:
                    strongconnect(w)
                    low[v] = min(low[v], low[w])
                elif w in on_stack:
                    low[v] = min(low[v], index[w])
            if low[v] == index[v]:
                comp: List[str] = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))

        for v in sorted(graph):
            if v not in index:
                strongconnect(v)
        return sccs

    # -- findings --------------------------------------------------------

    def findings(self) -> List[Finding]:
        out: List[Finding] = []
        out.extend(self._g09_findings())
        out.extend(self._g10_findings())
        out.extend(self._g11_findings())
        return out

    def _finding(self, rule: str, ev_module: str, lineno: int,
                 col: int, message: str) -> Finding:
        m = self.modules[ev_module]
        code = ""
        if 1 <= lineno <= len(m.lines):
            code = m.lines[lineno - 1].strip()
        return Finding(rule=rule, path=m.path, line=lineno, col=col,
                       message=message, code=code)

    def _g09_findings(self) -> List[Finding]:
        by_key: Dict[str, List[_Event]] = {}
        for ev in self._events:
            if ev.kind == "access":
                by_key.setdefault(ev.target, []).append(ev)
        out: List[Finding] = []
        for key in sorted(by_key):
            accesses = by_key[key]
            cls = key.split(":", 1)[1].rsplit(".", 2)
            owner_cls = cls[0] if len(cls) > 1 else None
            live = [ev for ev in accesses
                    if not (owner_cls and ev.fn.cls == owner_cls
                            and ev.fn.name in ("__init__", "__post_init__",
                                               "__new__"))]
            roots: Set[str] = set()
            for ev in live:
                roots |= set(ev.fn.roots)
            if len(roots) < 2:
                continue
            if self.canon(key) in self.lock_kinds \
                    or key in self._lock_alias or key in self.sync_keys:
                continue    # locks/Events/Queues are not unguarded state
            guard_pool: Set[str] = set()
            for ev in live:
                guard_pool |= ev.held
            writes = [ev for ev in live if ev.extra != "read"]
            label_bits = sorted(self.root_labels.get(r, r)
                                for r in roots)[:3]
            short = key.split(":", 1)[1]
            for ev in writes:
                if ev.held:
                    continue
                if guard_pool:
                    out.append(self._finding(
                        "G09", ev.fn.module, ev.node.lineno,
                        getattr(ev.node, "col_offset", 0),
                        f"shared state '{short}' (reached from "
                        f"{', '.join(label_bits)}) is mutated in "
                        f"{ev.fn.qualname} without the guard held at its "
                        f"other access sites "
                        f"({', '.join(sorted(_short_lock(g) for g in guard_pool))})"))
                elif ev.extra in ("aug", "mutcall", "subscript", "del"):
                    verb = ("non-atomic read-modify-write on"
                            if ev.extra == "aug" else
                            "unsynchronized container mutation of")
                    out.append(self._finding(
                        "G09", ev.fn.module, ev.node.lineno,
                        getattr(ev.node, "col_offset", 0),
                        f"{verb} shared state '{short}' in "
                        f"{ev.fn.qualname}: reached from "
                        f"{', '.join(label_bits)} and never guarded by "
                        f"any lock — add a lock or confine it to one "
                        f"thread"))
        return out

    def _g10_findings(self) -> List[Finding]:
        out: List[Finding] = []
        # non-reentrant self-acquisition (with L: ... with L:)
        for ev in self._events:
            if ev.kind != "acq" or ev.target.startswith("?"):
                continue
            if ev.target in ev.held \
                    and self.canon_kind(ev.target) != "rlock":
                out.append(self._finding(
                    "G10", ev.fn.module, ev.node.lineno,
                    getattr(ev.node, "col_offset", 0),
                    f"{ev.fn.qualname} re-acquires non-reentrant lock "
                    f"{_short_lock(ev.target)} already held on this "
                    f"path — guaranteed self-deadlock"))
        for comp in self.lock_cycles():
            cyc_edges = [(a, b) for (a, b) in self.lock_edges
                         if a in comp and b in comp]
            sites = sorted((self.lock_edges[e], e) for e in cyc_edges)
            (path, lineno, _), _ = sites[0]
            chain = "; ".join(
                f"{_short_lock(a)} -> {_short_lock(b)} at "
                f"{self.lock_edges[(a, b)][0]}:{self.lock_edges[(a, b)][1]}"
                f" ({self.lock_edges[(a, b)][2]})"
                for (a, b) in sorted(cyc_edges))
            m = self._by_path[path]
            out.append(self._finding(
                "G10", m.mod, lineno, 0,
                f"lock-order cycle across {{{', '.join(_short_lock(k) for k in comp)}}}"
                f" — potential deadlock: {chain}"))
        return out

    def _g11_findings(self) -> List[Finding]:
        out: List[Finding] = []
        contended_cache: Dict[str, bool] = {}

        def contended(lock: str) -> bool:
            if lock not in contended_cache:
                contended_cache[lock] = len(self.lock_roots(lock)) >= 2
            return contended_cache[lock]

        for ev in self._events:
            if ev.kind != "call" or not ev.held:
                continue
            locks = sorted(h for h in ev.held
                           if not h.startswith("?") and contended(h))
            if not locks:
                continue
            reason = self._blocking_reason(ev)
            via = None
            if reason is None and not _timeout_zero(ev.extra):
                target = self._resolve_callee(ev.target, ev.fn)
                if target is not None and not target.spawn_target:
                    found = self.transitive_blocking(target)
                    if found:
                        reason, via = found
            if reason is None:
                continue
            hop = f" (via {via})" if via else ""
            out.append(self._finding(
                "G11", ev.fn.module, ev.node.lineno,
                getattr(ev.node, "col_offset", 0),
                f"blocking call {reason} while holding contended lock"
                f"{'s' if len(locks) > 1 else ''} "
                f"{', '.join(_short_lock(h) for h in locks)} in "
                f"{ev.fn.qualname}{hop} — every other thread queuing on "
                f"the lock stalls behind it; move the blocking work "
                f"outside the critical section"))
        return out


def build_model(file_texts: Mapping[str, str],
                trees: Optional[Mapping[str, ast.Module]] = None
                ) -> ThreadModel:
    """Build the whole-tree concurrency model from ``{repo-relative
    posix path: source text}`` — the fixture-facing entry point.
    ``trees`` (same keys) skips re-parsing files the caller parsed."""
    return ThreadModel(file_texts, trees)


def collect_thread_findings(
        file_texts: Mapping[str, str],
        trees: Optional[Mapping[str, ast.Module]] = None) -> List[Finding]:
    """Run the layer over the given tree and return suppression-filtered
    findings (``# graftlint: disable=G09 reason`` works exactly like the
    per-file rules)."""
    model = build_model(file_texts, trees)
    out: List[Finding] = []
    supp: Dict[str, Dict[int, List[str]]] = {}
    for f in model.findings():
        if f.path not in supp:
            supp[f.path] = parse_suppressions(
                file_texts[f.path].splitlines())
        if not suppressed(f, supp[f.path]):
            out.append(f)
    return out


def model_from_paths(paths: Sequence[str],
                     root: Optional[str] = None) -> ThreadModel:
    """Convenience for tests: read files/dirs like ``lint_paths`` does
    and build the model over them (repo-relative paths)."""
    import os

    from .cli import iter_python_files, repo_root

    root = os.path.abspath(root or repo_root())
    texts: Dict[str, str] = {}
    for fname in iter_python_files(paths):
        try:
            with open(fname, encoding="utf-8") as f:
                text = f.read()
        except OSError:
            continue
        rel = os.path.relpath(os.path.abspath(fname), root)
        texts[rel.replace(os.sep, "/")] = text
    return build_model(texts)
