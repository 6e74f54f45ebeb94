"""dklint interprocedural core: the whole-repo graph.

The per-file rules reason one file at a time; every rule that wants to see
across a call or an inheritance edge re-derives its own slice of the
project.  This module builds that structure ONCE per run and hands it to
``ProjectRule``s (``rules_project.py``):

* **modules** — every scanned file, keyed by dotted module name derived
  from its anchored relative path (``distkeras_tpu_torch/serve/router.py`` ->
  ``distkeras_tpu_torch.serve.router``), with its import table resolved
  (absolute, aliased, and package-relative ``from .. import`` forms).
* **class hierarchy** — classes with bases resolved through the import
  table to project classes where possible, so "is ``attr`` guarded in a
  base?" is one chain walk (the lock-discipline idiom, centralized).
* **call graph** — per-function outgoing edges resolved for the shapes
  that matter here: bare-name calls, ``self.method()`` through the
  hierarchy, ``self.attr.method()`` / ``local.method()`` through the
  attribute/local type maps, and ``module.fn()`` through imports.
  Resolution is deliberately best-effort: an unresolved call is simply
  absent (rules built on this follow ONE call-edge level, the jit-purity
  precedent, so a missing edge costs recall, never a false positive).
* **lock model** — per class: owned locks (``self.X = threading.Lock()``
  / ``RLock()``), condition aliases (``self.C =
  threading.Condition(self.X)`` acquires ``X``), and per-function
  acquisition sites (``with <lockref>:`` scopes plus ``# dklint:
  holds=<lock>`` pragmas declaring locks held at entry).  Lock IDENTITY
  resolves to the defining class in the hierarchy — a subclass's
  ``with self.mutex:`` and the base that created ``mutex`` name the
  same node, so the lock-order graph never splits one mutex into two.
* **attribute/local types** — ``self.a = ClassName(...)`` in any
  method, one constructor back-propagation pass (``KVFabric(self)``
  inside ``ServeRouter`` binds ``KVFabric.router -> ServeRouter`` when
  its ``__init__`` stores the parameter), and per-function locals bound
  by ``v = ClassName(...)`` / ``v = self.attr``.

Everything here is pure AST bookkeeping — no imports of scanned code.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .core import FileContext

_LOCK_CTORS = {"Lock": "Lock", "RLock": "RLock"}

#: containers whose in-place mutation needs a guard once shared
_MUTABLE_CTORS = {"dict", "list", "set", "deque", "defaultdict",
                  "OrderedDict", "Counter"}


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _terminal(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def module_name_for(rel: str) -> str:
    """Anchored relative path -> dotted module name.
    ``a/b/c.py`` -> ``a.b.c``; ``a/b/__init__.py`` -> ``a.b``;
    a bare ``foo.py`` (fixture sources) -> ``foo``."""
    rel = rel.replace("\\", "/")
    if rel.endswith(".py"):
        rel = rel[:-3]
    parts = [p for p in rel.split("/") if p]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) or "<module>"


class FuncInfo:
    """One function or method definition."""

    __slots__ = ("name", "qname", "node", "module", "cls",
                 "acquires", "calls")

    def __init__(self, name: str, qname: str, node: ast.AST,
                 module: "ModuleInfo", cls: Optional["ClassInfo"]):
        self.name = name
        self.qname = qname
        self.node = node
        self.module = module
        self.cls = cls
        #: direct lexical lock acquisitions: [(LockNode, ast node)]
        self.acquires: List[Tuple["LockNode", ast.AST]] = []
        #: resolved outgoing call edges: [(FuncInfo, call ast node)]
        self.calls: List[Tuple["FuncInfo", ast.Call]] = []


class ClassInfo:
    """One class definition with its resolved shape."""

    def __init__(self, name: str, qname: str, node: ast.ClassDef,
                 module: "ModuleInfo"):
        self.name = name
        self.qname = qname
        self.node = node
        self.module = module
        self.base_names: List[str] = [
            b for b in (_dotted(x) for x in node.bases) if b]
        self.bases: List["ClassInfo"] = []       # resolved project bases
        self.methods: Dict[str, FuncInfo] = {}
        #: lock attr -> "Lock" | "RLock"
        self.locks: Dict[str, str] = {}
        #: condition/alias attr -> underlying lock attr
        self.lock_aliases: Dict[str, str] = {}
        #: self.attr -> ClassInfo (constructor-typed attributes)
        self.attr_types: Dict[str, "ClassInfo"] = {}
        #: attrs holding bare mutable containers assigned in __init__
        self.mutable_attrs: Set[str] = set()

    def mro_chain(self, _depth: int = 0) -> List["ClassInfo"]:
        """self + resolved project bases, nearest first (bounded)."""
        chain = [self]
        if _depth < 8:
            for b in self.bases:
                for c in b.mro_chain(_depth + 1):
                    if c not in chain:
                        chain.append(c)
        return chain

    def find_method(self, name: str) -> Optional[FuncInfo]:
        for c in self.mro_chain():
            m = c.methods.get(name)
            if m is not None:
                return m
        return None

    def lock_kind(self, attr: str) -> Optional[str]:
        """``Lock``/``RLock`` for ``attr`` (aliases followed) anywhere in
        the hierarchy, else None."""
        node = self.resolve_lock(attr)
        if node is None:
            return None
        return node.kind

    def resolve_lock(self, attr: str) -> Optional["LockNode"]:
        """Lock node for ``self.<attr>`` as seen from this class: the
        DEFINING class in the hierarchy owns the identity; condition
        aliases resolve to their underlying lock."""
        for c in self.mro_chain():
            under = c.lock_aliases.get(attr)
            if under is not None:
                return self.resolve_lock(under)
            if attr in c.locks:
                return LockNode(c, attr, c.locks[attr])
        return None

    def has_any_lock(self) -> bool:
        return any(c.locks for c in self.mro_chain())


class LockNode:
    """Identity of one lock: (defining class, attribute)."""

    __slots__ = ("cls", "attr", "kind")

    def __init__(self, cls: ClassInfo, attr: str, kind: str):
        self.cls = cls
        self.attr = attr
        self.kind = kind  # "Lock" | "RLock"

    @property
    def id(self) -> str:
        return f"{self.cls.qname}.{self.attr}"

    @property
    def label(self) -> str:
        return f"{self.cls.name}.{self.attr}"

    def __eq__(self, other) -> bool:
        return isinstance(other, LockNode) and self.id == other.id

    def __hash__(self) -> int:
        return hash(self.id)

    def __repr__(self) -> str:
        return f"LockNode({self.id})"


class ModuleInfo:
    """One scanned file: import table + top-level defs."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.name = module_name_for(ctx.rel)
        #: local name -> dotted absolute target (module or symbol)
        self.imports: Dict[str, str] = {}
        self.functions: Dict[str, FuncInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self._scan_imports()

    # -- imports ------------------------------------------------------------
    def _package_parts(self) -> List[str]:
        parts = self.name.split(".")
        rel = self.ctx.rel.replace("\\", "/")
        if rel.endswith("/__init__.py"):
            return parts          # a package imports relative to itself
        return parts[:-1]

    def _scan_imports(self) -> None:
        for node in ast.walk(self.ctx.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    target = alias.name if alias.asname else \
                        alias.name.split(".")[0]
                    self.imports[local] = target
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = self._package_parts()
                    if node.level > 1:
                        base = base[:-(node.level - 1)] or base
                    prefix = ".".join(base)
                    mod = f"{prefix}.{node.module}" if node.module \
                        else prefix
                else:
                    mod = node.module or ""
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    self.imports[local] = f"{mod}.{alias.name}"


class ProjectGraph:
    """The whole-repo structure: modules, classes, functions, call graph
    and the lock model.  Build with :func:`build_graph` (from paths) or
    directly from parsed ``FileContext``s."""

    def __init__(self, contexts: Sequence[FileContext]):
        self.modules: Dict[str, ModuleInfo] = {}
        self.contexts: List[FileContext] = list(contexts)
        for ctx in contexts:
            mod = ModuleInfo(ctx)
            self.modules[mod.name] = mod
        #: every FuncInfo in the project (iteration order = definition)
        self.functions: List[FuncInfo] = []
        self._collect_defs()
        self._resolve_bases()
        self._extract_class_shapes()
        self._backprop_ctor_params()
        self._resolve_calls_and_locks()

    # -- phase 1: definitions ----------------------------------------------
    def _collect_defs(self) -> None:
        for mod in self.modules.values():
            for node in mod.ctx.tree.body:
                self._collect_in(mod, node, None)

    def _collect_in(self, mod: ModuleInfo, node: ast.AST,
                    cls: Optional[ClassInfo]) -> None:
        if isinstance(node, ast.ClassDef):
            qname = f"{mod.name}.{node.name}"
            info = ClassInfo(node.name, qname, node, mod)
            mod.classes[node.name] = info
            for item in node.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    fn = FuncInfo(item.name, f"{qname}.{item.name}",
                                  item, mod, info)
                    info.methods[item.name] = fn
                    self.functions.append(fn)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = FuncInfo(node.name, f"{mod.name}.{node.name}",
                          node, mod, None)
            mod.functions[node.name] = fn
            self.functions.append(fn)

    # -- phase 2: class hierarchy -------------------------------------------
    def resolve_class(self, mod: ModuleInfo,
                      dotted: Optional[str]) -> Optional[ClassInfo]:
        """Resolve a dotted name as seen from ``mod`` to a project
        class: local class, imported symbol, or ``alias.Class`` through
        an imported module."""
        if not dotted:
            return None
        parts = dotted.split(".")
        if len(parts) == 1:
            cls = mod.classes.get(parts[0])
            if cls is not None:
                return cls
            target = mod.imports.get(parts[0])
            if target is not None:
                return self._class_by_qname(target)
            return None
        head = mod.imports.get(parts[0])
        if head is not None:
            return self._class_by_qname(".".join([head] + parts[1:]))
        return self._class_by_qname(dotted)

    def _class_by_qname(self, qname: str) -> Optional[ClassInfo]:
        mod_name, _, cls_name = qname.rpartition(".")
        m = self.modules.get(mod_name)
        if m is not None and cls_name in m.classes:
            return m.classes[cls_name]
        # symbol re-exported through a package __init__: follow one hop
        m = self.modules.get(qname.rpartition(".")[0])
        if m is None:
            m = self.modules.get(qname)
        if m is not None:
            target = m.imports.get(cls_name) if cls_name else None
            if target is not None and target != qname:
                return self._class_by_qname(target)
        return None

    def resolve_function(self, mod: ModuleInfo,
                         dotted: Optional[str]) -> Optional[FuncInfo]:
        """Bare or dotted callable as seen from ``mod`` -> FuncInfo (a
        class name resolves to its ``__init__``)."""
        if not dotted:
            return None
        parts = dotted.split(".")
        if len(parts) == 1:
            fn = mod.functions.get(parts[0])
            if fn is not None:
                return fn
            cls = mod.classes.get(parts[0])
            if cls is not None:
                return cls.find_method("__init__")
            target = mod.imports.get(parts[0])
            if target is not None:
                return self._func_by_qname(target)
            return None
        head = mod.imports.get(parts[0])
        if head is not None:
            return self._func_by_qname(".".join([head] + parts[1:]))
        return self._func_by_qname(dotted)

    def _func_by_qname(self, qname: str) -> Optional[FuncInfo]:
        mod_name, _, fn_name = qname.rpartition(".")
        m = self.modules.get(mod_name)
        if m is not None:
            if fn_name in m.functions:
                return m.functions[fn_name]
            if fn_name in m.classes:
                return m.classes[fn_name].find_method("__init__")
            target = m.imports.get(fn_name)
            if target is not None and target != qname:
                return self._func_by_qname(target)
        cls = self._class_by_qname(qname)
        if cls is not None:
            return cls.find_method("__init__")
        return None

    def _resolve_bases(self) -> None:
        for mod in self.modules.values():
            for cls in mod.classes.values():
                for b in cls.base_names:
                    base = self.resolve_class(mod, b)
                    if base is not None and base is not cls:
                        cls.bases.append(base)

    # -- phase 3: lock model + attribute types ------------------------------
    def _extract_class_shapes(self) -> None:
        for mod in self.modules.values():
            for cls in mod.classes.values():
                for name, fn in cls.methods.items():
                    self._scan_method_assigns(mod, cls, fn,
                                              in_init=(name == "__init__"))

    def _scan_method_assigns(self, mod: ModuleInfo, cls: ClassInfo,
                             fn: FuncInfo, in_init: bool) -> None:
        # parameter annotations type the attrs they're stored into:
        # ``def __init__(self, ps: ParameterServer): self.ps = ps``
        ann_params: Dict[str, ClassInfo] = {}
        for a in getattr(fn.node.args, "args", [])[1:]:
            if a.annotation is not None:
                t = self.resolve_class(mod, _dotted(a.annotation))
                if t is not None:
                    ann_params[a.arg] = t
        for node in ast.walk(fn.node):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            value = node.value
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            attrs = [a for a in (_self_attr(t) for t in targets) if a]
            if attrs and isinstance(node, ast.AnnAssign) and \
                    node.annotation is not None:
                t = self.resolve_class(mod, _dotted(node.annotation))
                if t is not None:
                    for attr in attrs:
                        cls.attr_types.setdefault(attr, t)
            if attrs and isinstance(value, ast.Name) and \
                    value.id in ann_params:
                for attr in attrs:
                    cls.attr_types.setdefault(attr, ann_params[value.id])
            if not attrs or not isinstance(value, ast.Call):
                if attrs and in_init and isinstance(
                        value, (ast.Dict, ast.List, ast.Set,
                                ast.DictComp, ast.ListComp, ast.SetComp)):
                    cls.mutable_attrs.update(attrs)
                continue
            term = _terminal(value.func)
            for attr in attrs:
                if term in _LOCK_CTORS:
                    cls.locks[attr] = _LOCK_CTORS[term]
                elif term == "Condition":
                    under = _self_attr(value.args[0]) if value.args \
                        else None
                    if under:
                        cls.lock_aliases[attr] = under
                    else:
                        # a Condition() owns a fresh internal lock
                        cls.locks[attr] = "RLock"
                elif term in _MUTABLE_CTORS and in_init:
                    cls.mutable_attrs.add(attr)
                else:
                    target = self.resolve_class(mod,
                                                _dotted(value.func))
                    if target is not None:
                        cls.attr_types[attr] = target

    def _backprop_ctor_params(self) -> None:
        """One pass of constructor-parameter typing: a call
        ``K(self, ...)`` inside class C binds K.__init__'s first real
        parameter to C; ``self.p = that_param`` in K.__init__ then types
        ``K.p`` — how ``KVFabric(router)`` learns its ``.router``."""
        for fn in self.functions:
            local_types = self._local_types(fn)
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                callee_cls = self.resolve_class(fn.module,
                                                _dotted(node.func))
                if callee_cls is None:
                    continue
                init = callee_cls.find_method("__init__")
                if init is None or init.cls is None:
                    continue
                params = [a.arg for a in init.node.args.args[1:]]
                bindings: List[Tuple[str, ast.AST]] = list(
                    zip(params, node.args))
                bindings.extend((kw.arg, kw.value)
                                for kw in node.keywords
                                if kw.arg in params)
                for pname, arg in bindings:
                    bound: Optional[ClassInfo] = None
                    if isinstance(arg, ast.Name):
                        if arg.id == "self" and fn.cls is not None:
                            bound = fn.cls
                        else:
                            bound = local_types.get(arg.id)
                    attr = _self_attr(arg)
                    if attr is not None and fn.cls is not None:
                        bound = fn.cls.attr_types.get(attr)
                    if bound is None:
                        continue
                    for sub in ast.walk(init.node):
                        if isinstance(sub, ast.Assign) and \
                                isinstance(sub.value, ast.Name) and \
                                sub.value.id == pname:
                            for t in sub.targets:
                                a = _self_attr(t)
                                if a and a not in init.cls.attr_types:
                                    init.cls.attr_types[a] = bound

    # -- phase 4: calls + acquisitions --------------------------------------
    def _local_types(self, fn: FuncInfo) -> Dict[str, ClassInfo]:
        """Var -> class for simple local bindings inside ``fn``:
        ``v = ClassName(...)`` and ``v = self.attr`` (typed attrs)."""
        out: Dict[str, ClassInfo] = {}
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Assign) or \
                    len(node.targets) != 1 or \
                    not isinstance(node.targets[0], ast.Name):
                continue
            var = node.targets[0].id
            if isinstance(node.value, ast.Call):
                cls = self.resolve_class(fn.module,
                                         _dotted(node.value.func))
                if cls is not None:
                    out[var] = cls
            else:
                attr = _self_attr(node.value)
                if attr and fn.cls is not None:
                    t = fn.cls.attr_types.get(attr)
                    if t is not None:
                        out[var] = t
        return out

    def receiver_class(self, fn: FuncInfo, node: ast.AST,
                       local_types: Dict[str, ClassInfo]
                       ) -> Optional[ClassInfo]:
        """Best-effort type of an expression used as a receiver:
        ``self`` / ``self.attr`` / local var / local var's attr."""
        if isinstance(node, ast.Name):
            if node.id == "self" and fn.cls is not None:
                return fn.cls
            return local_types.get(node.id)
        if isinstance(node, ast.Attribute):
            owner = self.receiver_class(fn, node.value, local_types)
            if owner is not None:
                for c in owner.mro_chain():
                    t = c.attr_types.get(node.attr)
                    if t is not None:
                        return t
        return None

    def resolve_lock_ref(self, fn: FuncInfo, expr: ast.AST,
                         local_types: Dict[str, ClassInfo]
                         ) -> Optional[LockNode]:
        """``with <expr>:`` -> the lock node it acquires, when ``expr``
        is ``self.X`` / ``<typed receiver>.X`` and ``X`` is a lock (or
        condition alias) of the receiver's class hierarchy."""
        if not isinstance(expr, ast.Attribute):
            return None
        owner = self.receiver_class(fn, expr.value, local_types)
        if owner is None:
            return None
        return owner.resolve_lock(expr.attr)

    def _resolve_calls_and_locks(self) -> None:
        for fn in self.functions:
            local_types = self._local_types(fn)
            seen_locks: Set[str] = set()
            for node in ast.walk(fn.node):
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        lock = self.resolve_lock_ref(
                            fn, item.context_expr, local_types)
                        if lock is not None:
                            fn.acquires.append((lock, item.context_expr))
                            seen_locks.add(lock.id)
                elif isinstance(node, ast.Call):
                    callee = self._resolve_call(fn, node, local_types)
                    if callee is not None and callee is not fn:
                        fn.calls.append((callee, node))

    def _resolve_call(self, fn: FuncInfo, node: ast.Call,
                      local_types: Dict[str, ClassInfo]
                      ) -> Optional[FuncInfo]:
        func = node.func
        if isinstance(func, ast.Name):
            return self.resolve_function(fn.module, func.id)
        if isinstance(func, ast.Attribute):
            owner = self.receiver_class(fn, func.value, local_types)
            if owner is not None:
                return owner.find_method(func.attr)
            dotted = _dotted(func)
            if dotted is not None:
                return self.resolve_function(fn.module, dotted)
        return None

    # -- holds pragmas ------------------------------------------------------
    def held_at_entry(self, fn: FuncInfo) -> List[LockNode]:
        """Locks a ``# dklint: holds=`` pragma declares held when ``fn``
        is entered, resolved in the owning class's hierarchy (a subclass
        method may declare a base-class lock)."""
        if fn.cls is None:
            return []
        names = fn.module.ctx.holds(fn.node.lineno)
        out = []
        for n in sorted(names):
            lock = fn.cls.resolve_lock(n)
            if lock is not None:
                out.append(lock)
        return out


def build_graph(contexts: Iterable[FileContext]) -> ProjectGraph:
    """The one entry point rules use."""
    return ProjectGraph(list(contexts))
