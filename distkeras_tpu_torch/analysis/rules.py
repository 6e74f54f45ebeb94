"""dklint rules — the per-file static checks for the port's stack.

Nine rules, each targeting a hazard class this codebase has (the PS and
serving stacks are exactly the shape of code where these corrupt
training without failing a test):

* ``hot-path-purity`` — the port's twin of the JAX package's
  ``jit-purity``.  The port traces nothing (eager PyTorch: no
  ``torch.compile``, no CUDA graph), so its per-step hazards are host
  syncs and hidden randomness: ``.item()`` / ``.tolist()`` / ``.cpu()``
  / ``.numpy()``, ``float()`` / ``int()`` / ``bool()`` of a value,
  ``torch.cuda.synchronize()`` — each stalls the host until the card
  drains, every step — and draws from a global generator
  (``torch.rand*``, ``randint``, ``randperm``, ``bernoulli``,
  ``multinomial``, ``normal``, ``dropout``, the in-place
  ``uniform_``/``normal_``/``bernoulli_``/... without ``generator=``,
  ``np.random.*``), which break the port's explicit-generator rule.
  Hot functions are declared with a ``# dklint: hot`` pragma on the
  ``def`` line; functions called by name from a hot body are checked
  too (one call-edge level).
* ``lock-discipline`` — for classes owning a ``threading.Lock``, instance
  attributes written both under ``with <lock>`` and bare.  A method whose
  contract is "called with the lock held" declares it with a
  ``# dklint: holds=<lock>`` pragma on its ``def`` line.
* ``swallow-guard``   — catch-all handlers (``except:`` /
  ``except Exception:``) that neither re-raise, nor use the bound
  exception, nor log: the silent-corruption classic.
* ``thread-shutdown`` — daemon threads spawned in a scope with no stop
  event and no ``join()``: work that dies mid-write at interpreter exit.
* ``bare-print``      — ``print(`` in library code (output goes through
  ``obs.logging``'s ``emit``/``get_logger`` seam).
* ``staleness-protocol`` — commits built from a center pulled BEFORE the
  previous commit's reply: a ``commit`` repeated — in a loop, or
  back-to-back — without a fresh ``pull`` on the same receiver trains
  every window after the first against a stale center.
* ``shm-lifecycle`` — ``multiprocessing.shared_memory`` segments created
  (``SharedMemory(create=True)`` / ``ShmRing.create``) in a scope with
  no ``unlink`` on any shutdown path: a POSIX shm segment outlives the
  process.  Attach-only scopes (which must NOT unlink — the creator owns
  that) are not flagged.
* ``wire-seam`` — raw ``.recv(`` / ``.recv_into(`` / ``.sendall(`` /
  ``.sendmsg(`` calls outside ``ps/networking.py``: every wire byte must
  travel the one networking seam (framing, the chaos fault hook, the
  ``net.*`` byte counters).
* ``kv-version-guard`` — ``insert_remote(`` calls outside
  ``serve/kvfabric.py``: a remote KV tree may only enter a
  ``PrefixCache`` through the fabric's version-guarded seam
  (``admit_remote_entry``), or KV computed under different weights can
  serve wrong tokens.

Every rule but the first is the JAX package's, finding for finding.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .core import FileContext, Finding, Rule

# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------


def _dotted(node: ast.AST) -> Optional[str]:
    """Name/Attribute chain -> dotted string (``torch.cuda.synchronize``),
    else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _terminal(node: ast.AST) -> Optional[str]:
    """Last component of a Name/Attribute chain (``torch.rand`` ->
    ``rand``)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.X`` -> ``X``, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


# ---------------------------------------------------------------------------
# hot-path-purity (the torch twin of jit-purity)
# ---------------------------------------------------------------------------

#: method calls (no arguments) that copy a tensor to the host and wait
#: for the card
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}

#: builtins that concretize a value on the host
_CAST_BUILTINS = {"float", "int", "bool"}

#: methods whose result is already a host int: ``int(x.numel())``,
#: ``int(len(...))`` read no tensor data
_HOST_INT_METHODS = {"numel", "size", "dim", "ndimension", "element_size",
                     "nelement", "__len__"}

#: ``torch.X(...)`` draws from the global generator unless given
#: ``generator=``
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "bernoulli",
                "multinomial", "normal", "rand_like", "randn_like",
                "randint_like", "poisson"}

#: in-place draws on a tensor, global unless given ``generator=``
_INPLACE_DRAWS = {"uniform_", "normal_", "bernoulli_", "random_",
                  "exponential_", "geometric_", "log_normal_", "cauchy_"}


def _host_value(node: ast.AST) -> bool:
    """Arguments of ``int()``/``float()``/``bool()`` that read no tensor
    data: literals, shapes, ``len()`` and element counts."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Subscript):
        return _terminal(node.value) == "shape"
    if isinstance(node, ast.Attribute):
        return node.attr in ("shape", "ndim")
    if isinstance(node, ast.Call):
        return _terminal(node.func) in {"len"} | _HOST_INT_METHODS
    return False


class HotPathPurityRule(Rule):
    id = "hot-path-purity"
    description = ("host syncs and global-generator draws inside functions "
                   "marked `# dklint: hot` (the per-step path; functions "
                   "called by name from one are checked too — one "
                   "call-edge level)")

    def check(self, ctx: FileContext) -> List[Finding]:
        defs: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, []).append(node)

        hot: List[ast.AST] = []
        seen_ids: Set[int] = set()

        def mark(fn: ast.AST) -> None:
            if id(fn) not in seen_ids:
                seen_ids.add(id(fn))
                hot.append(fn)

        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and ctx.hot(node):
                mark(node)
        # one call-edge level: a function invoked BY NAME from a hot body
        # runs on the hot path too (attribute calls stay unresolved)
        for fn in list(hot):
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Name):
                    for callee in defs.get(node.func.id, []):
                        mark(callee)

        findings: List[Finding] = []
        flagged: Set[Tuple[int, int]] = set()

        def flag(node: ast.AST, what: str) -> None:
            key = (node.lineno, node.col_offset)
            if key in flagged:
                return
            flagged.add(key)
            findings.append(self.finding(
                ctx, node, f"{what} on the hot path (runs every step; "
                           f"keep it off the per-step path, or disable "
                           f"with a pragma that says why)"))

        for fn in hot:
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                dotted = _dotted(node.func) or ""
                parts = dotted.split(".")
                term = parts[-1] if parts else ""
                seeded = any(kw.arg == "generator" for kw in node.keywords)
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _SYNC_METHODS and not node.args:
                    flag(node, f"device->host sync `.{node.func.attr}()`")
                elif dotted in ("torch.cuda.synchronize", "cuda.synchronize"):
                    flag(node, "device sync `torch.cuda.synchronize()`")
                elif isinstance(node.func, ast.Name) and \
                        term in _CAST_BUILTINS and node.args and \
                        not _host_value(node.args[0]):
                    flag(node, f"host concretization `{term}(...)`")
                elif len(parts) == 2 and parts[0] == "torch" and \
                        term in _TORCH_DRAWS and not seeded:
                    flag(node, f"global-generator draw `{dotted}()` (pass "
                               f"an explicit generator=)")
                elif term == "dropout" and parts[0] in ("F", "torch",
                                                         "nn", "functional"):
                    flag(node, f"global-generator draw `{dotted}()` "
                               f"(no generator= exists: draw the mask from "
                               f"an explicit generator)")
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _INPLACE_DRAWS and not seeded:
                    flag(node, f"global-generator draw `.{node.func.attr}()`"
                               f" (pass an explicit generator=)")
                elif len(parts) == 3 and parts[0] in ("np", "numpy") and \
                        parts[1] == "random" and term != "default_rng":
                    flag(node, f"global-state RNG `{dotted}()` (use an "
                               f"explicit generator)")
        return findings


# ---------------------------------------------------------------------------
# lock-discipline
# ---------------------------------------------------------------------------

#: container methods that mutate their receiver
_MUTATORS = {"append", "extend", "insert", "remove", "pop", "popitem",
             "popleft", "appendleft", "clear", "update", "setdefault",
             "add", "discard", "sort", "reverse"}

_LOCK_CTORS = {"Lock", "RLock"}


class _ClassRecord:
    """Per-class write ledger: attr -> write sites split by lock state."""

    def __init__(self, node: ast.ClassDef):
        self.node = node
        self.bases = [_terminal(b) for b in node.bases]
        self.locks: Set[str] = set()
        #: attr -> lock names it was written under
        self.inside: Dict[str, Set[str]] = {}
        #: attr -> [(write node, method name)] for unguarded writes
        self.outside: Dict[str, List[Tuple[ast.AST, str]]] = {}


class LockDisciplineRule(Rule):
    id = "lock-discipline"
    description = ("instance attributes written both under `with <lock>` "
                   "and bare, in classes that own a threading.Lock")

    def check(self, ctx: FileContext) -> List[Finding]:
        classes: Dict[str, _ClassRecord] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                classes[node.name] = _ClassRecord(node)

        for rec in classes.values():
            for node in ast.walk(rec.node):
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                    targets = [node.target]
                for t in targets:
                    attr = _self_attr(t)
                    if attr and isinstance(getattr(node, "value", None),
                                           ast.Call) and \
                            _terminal(node.value.func) in _LOCK_CTORS:
                        rec.locks.add(attr)

        def chain_locks(rec: _ClassRecord, depth: int = 0) -> Set[str]:
            locks = set(rec.locks)
            if depth < 8:  # defensive bound on malformed hierarchies
                for b in rec.bases:
                    if b in classes:
                        locks |= chain_locks(classes[b], depth + 1)
            return locks

        for rec in classes.values():
            locks = chain_locks(rec)
            if not locks:
                continue
            for item in rec.node.body:
                if not isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if item.name == "__init__":
                    continue  # construction happens-before every thread
                self._scan(rec, item, locks,
                           held=set(ctx.holds(item.lineno)))

        findings: List[Finding] = []

        def chain_inside(rec: _ClassRecord,
                         depth: int = 0) -> Dict[str, Set[str]]:
            """attr -> lock names it is written under, across the local
            class hierarchy (a subclass writing bare to an attribute the
            base guards is exactly the bug this rule exists for)."""
            out: Dict[str, Set[str]] = {}
            if depth < 8:
                for b in rec.bases:
                    if b in classes:
                        for a, ls in chain_inside(classes[b],
                                                  depth + 1).items():
                            out.setdefault(a, set()).update(ls)
            for a, ls in rec.inside.items():
                out.setdefault(a, set()).update(ls)
            return out

        for rec in classes.values():
            if not chain_locks(rec):
                continue
            guarded = chain_inside(rec)
            for attr, sites in sorted(rec.outside.items()):
                if attr not in guarded:
                    continue
                locks_txt = ",".join(sorted(guarded[attr])) or \
                    ",".join(sorted(chain_locks(rec)))
                for node, method in sites:
                    findings.append(self.finding(
                        ctx, node,
                        f"`self.{attr}` written in `{rec.node.name}."
                        f"{method}` without holding `self.{locks_txt}` "
                        f"(written under the lock elsewhere); guard it, "
                        f"or declare the contract with "
                        f"`# dklint: holds={locks_txt}`"))
        return findings

    def _scan(self, rec: _ClassRecord, method: ast.AST, locks: Set[str],
              held: Set[str]) -> None:
        """Walk one method body tracking which owned locks are lexically
        held; record every self-attribute write on the proper side."""

        def record(node: ast.AST, attr: str, held_now: Set[str]) -> None:
            if attr in locks:
                return  # rebinding the lock itself is not data
            if held_now:
                rec.inside.setdefault(attr, set()).update(held_now)
            else:
                rec.outside.setdefault(attr, []).append((node, method.name))

        def write_targets(node: ast.AST) -> List[str]:
            attrs = []
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets = [node.target]
            for t in targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                for e in elts:
                    a = _self_attr(e)
                    if a:
                        attrs.append(a)
                    elif isinstance(e, ast.Subscript):
                        a = _self_attr(e.value)
                        if a:
                            attrs.append(a)
            return attrs

        def visit(node: ast.AST, held_now: Set[str]) -> None:
            if isinstance(node, ast.With):
                acquired = set()
                for item in node.items:
                    a = _self_attr(item.context_expr)
                    if a in locks:
                        acquired.add(a)
                for child in node.body:
                    visit(child, held_now | acquired)
                return
            for attr in write_targets(node):
                record(node, attr, held_now)
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _MUTATORS:
                attr = _self_attr(node.func.value)
                if attr:
                    record(node, attr, held_now)
            for child in ast.iter_child_nodes(node):
                visit(child, held_now)

        for child in method.body:
            visit(child, set(held))


# ---------------------------------------------------------------------------
# swallow-guard
# ---------------------------------------------------------------------------

#: calls that count as "the handler tells someone": logging, tracebacks,
#: the library's console seam
_DIAGNOSTIC_CALLS = {"print_exc", "print_exception", "format_exc", "emit",
                     "warning", "warn", "error", "exception", "log",
                     "debug", "info", "critical", "fail"}


class SwallowGuardRule(Rule):
    id = "swallow-guard"
    description = ("catch-all except handlers that neither re-raise, use "
                   "the exception, nor log it")

    def check(self, ctx: FileContext) -> List[Finding]:
        findings = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not self._catches_all(node.type):
                continue
            if self._handled(node):
                continue
            what = "bare `except:`" if node.type is None else \
                f"`except {_dotted(node.type) or 'Exception'}:`"
            findings.append(self.finding(
                ctx, node,
                f"{what} swallows every error silently; catch specific "
                f"exception types, or log/re-raise what you catch"))
        return findings

    @staticmethod
    def _catches_all(type_node: Optional[ast.AST]) -> bool:
        if type_node is None:
            return True
        elts = type_node.elts if isinstance(type_node, ast.Tuple) \
            else [type_node]
        return any(_terminal(e) in ("Exception", "BaseException")
                   for e in elts)

    @staticmethod
    def _handled(handler: ast.ExceptHandler) -> bool:
        for node in handler.body:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Raise):
                    return True
                if handler.name and isinstance(sub, ast.Name) and \
                        sub.id == handler.name:
                    return True  # bound exception is used (stored/wrapped)
                if isinstance(sub, ast.Call) and \
                        _terminal(sub.func) in _DIAGNOSTIC_CALLS:
                    return True
        return False


# ---------------------------------------------------------------------------
# thread-shutdown
# ---------------------------------------------------------------------------


class ThreadShutdownRule(Rule):
    id = "thread-shutdown"
    description = ("daemon threads spawned in a scope with no stop event "
                   "and no join(): dies mid-write at interpreter exit")

    def check(self, ctx: FileContext) -> List[Finding]:
        parents: Dict[int, ast.AST] = {}
        for node in ast.walk(ctx.tree):
            for child in ast.iter_child_nodes(node):
                parents[id(child)] = node

        def scope_of(node: ast.AST) -> ast.AST:
            """Nearest enclosing ClassDef, else the outermost FunctionDef,
            else the module — the region where a stop/join path for this
            thread would plausibly live."""
            cur, outer_fn = node, None
            while id(cur) in parents:
                cur = parents[id(cur)]
                if isinstance(cur, ast.ClassDef):
                    return cur
                if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    outer_fn = cur
            return outer_fn if outer_fn is not None else ctx.tree

        findings = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call) and
                    _terminal(node.func) == "Thread"):
                continue
            daemon = any(kw.arg == "daemon" and
                         isinstance(kw.value, ast.Constant) and
                         kw.value.value is True for kw in node.keywords)
            if not daemon:
                continue
            scope = scope_of(node)
            if self._has_shutdown_path(scope):
                continue
            findings.append(self.finding(
                ctx, node,
                "daemon thread spawned with no stop event or join() in "
                "scope — it dies mid-operation at interpreter exit; add a "
                "threading.Event + bounded join() shutdown path"))
        return findings

    @staticmethod
    def _has_shutdown_path(scope: ast.AST) -> bool:
        for node in ast.walk(scope):
            if isinstance(node, ast.Call):
                if _terminal(node.func) == "Event":
                    return True
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "join":
                    recv = node.func.value
                    if isinstance(recv, ast.Constant):
                        continue  # "sep".join(...) — string joining
                    dotted = _dotted(recv) or ""
                    if dotted.split(".")[-1] in ("path", "posixpath",
                                                 "ntpath", "os"):
                        continue  # os.path.join(...) — path joining
                    return True  # a thread/process join
        return False


# ---------------------------------------------------------------------------
# bare-print
# ---------------------------------------------------------------------------


class BarePrintRule(Rule):
    id = "bare-print"
    description = ("print() in library code — route output through "
                   "obs.logging (emit / get_logger)")

    def check(self, ctx: FileContext) -> List[Finding]:
        return [
            self.finding(ctx, node,
                         "bare print() in library code; use obs.logging's "
                         "emit() for CLI output or get_logger() for "
                         "diagnostics")
            for node in ast.walk(ctx.tree)
            if isinstance(node, ast.Call) and
            isinstance(node.func, ast.Name) and node.func.id == "print"
        ]


# ---------------------------------------------------------------------------
# staleness-protocol
# ---------------------------------------------------------------------------


def _walk_same_scope(node: ast.AST):
    """Yield ``node`` and descendants WITHOUT descending into nested
    function/class/lambda bodies — a pull inside a nested def is not a
    pull on this scope's protocol timeline."""
    stack = [node]
    while stack:
        cur = stack.pop()
        yield cur
        for child in ast.iter_child_nodes(cur):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            stack.append(child)


def _rpc_receiver(call: ast.Call, method: str) -> Optional[str]:
    """``client.pull(...)`` -> ``"client"`` (dotted receivers included:
    ``self._client.commit`` -> ``"self._client"``), else None."""
    if isinstance(call.func, ast.Attribute) and call.func.attr == method:
        return _dotted(call.func.value)
    return None


class StalenessProtocolRule(Rule):
    id = "staleness-protocol"
    description = ("commits built from a center pulled before the previous "
                   "commit's reply (a repeated commit with no fresh pull on "
                   "the same receiver)")

    def check(self, ctx: FileContext) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_fn(ctx, node, findings)
        return findings

    def _check_fn(self, ctx: FileContext, fn: ast.AST,
                  findings: List[Finding]) -> None:
        # only receivers that PULL somewhere in this function follow the
        # pull/commit protocol; a commit-only stream (gradient push, no
        # center) is a different protocol, not a staleness bug
        pulled = set()
        for node in _walk_same_scope(fn):
            if isinstance(node, ast.Call):
                r = _rpc_receiver(node, "pull")
                if r:
                    pulled.add(r)
        if not pulled:
            return
        flagged: Set[int] = set()

        def flag(call: ast.Call, recv: str) -> None:
            if id(call) in flagged:
                return
            flagged.add(id(call))
            findings.append(self.finding(
                ctx, call,
                f"`{recv}.commit(...)` repeats without a fresh "
                f"`{recv}.pull()` since the previous commit — the delta "
                f"is built from a center pulled before the previous "
                f"commit's reply; pull at every window boundary"))

        def events_in(stmts) -> Tuple[Set[str], dict]:
            pulls: Set[str] = set()
            commits: dict = {}
            for stmt in stmts:
                for node in _walk_same_scope(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    r = _rpc_receiver(node, "pull")
                    if r in pulled:
                        pulls.add(r)
                    r = _rpc_receiver(node, "commit")
                    if r in pulled and r not in commits:
                        commits[r] = node
            return pulls, commits

        # state per receiver: None (no pull yet — protocol not started),
        # "fresh" (pulled since the last commit), "stale" (committed
        # since the last pull).  Exclusive branches (if/else, try
        # handlers) each run on a COPY and merge optimistically — fresh
        # beats None beats stale — so one commit per mutually exclusive
        # branch is never misread as a repeated commit.
        _RANK = {"fresh": 0, None: 1, "stale": 2}

        def merge(*branch_states: dict) -> dict:
            keys = set().union(*[set(s) for s in branch_states])
            return {k: min((s.get(k) for s in branch_states),
                           key=_RANK.__getitem__) for k in keys}

        def visit(stmts, state: dict) -> None:
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                    body = list(stmt.body) + list(stmt.orelse)
                    pulls_in, commits_in = events_in(body)
                    for recv, call in commits_in.items():
                        # a loop that commits but never pulls re-commits
                        # from whatever was pulled BEFORE the loop
                        if recv not in pulls_in and \
                                state.get(recv) is not None:
                            flag(call, recv)
                    visit(stmt.body, state)
                    visit(stmt.orelse, state)
                    continue
                if isinstance(stmt, ast.If):
                    branches = []
                    for body in (stmt.body, stmt.orelse):
                        b = dict(state)
                        visit(body, b)
                        branches.append(b)
                    state.clear()
                    state.update(merge(*branches))
                    continue
                if isinstance(stmt, ast.Try):
                    main = dict(state)
                    visit(list(stmt.body) + list(stmt.orelse), main)
                    paths = [main]
                    for h in stmt.handlers:  # exceptional alternates
                        hb = dict(state)
                        visit(h.body, hb)
                        paths.append(hb)
                    state.clear()
                    state.update(merge(*paths))
                    visit(stmt.finalbody, state)
                    continue
                if isinstance(stmt, (ast.With, ast.AsyncWith)):
                    visit(stmt.body, state)
                    continue
                # plain statement: protocol events in lexical order
                calls = [n for n in _walk_same_scope(stmt)
                         if isinstance(n, ast.Call)]
                calls.sort(key=lambda n: (n.lineno, n.col_offset))
                for call in calls:
                    r = _rpc_receiver(call, "pull")
                    if r in pulled:
                        state[r] = "fresh"
                        continue
                    r = _rpc_receiver(call, "commit")
                    if r in pulled:
                        if state.get(r) == "stale":
                            flag(call, r)
                        if state.get(r) is not None:
                            state[r] = "stale"

        visit(fn.body, {})


# ---------------------------------------------------------------------------
# shm-lifecycle
# ---------------------------------------------------------------------------


class ShmLifecycleRule(Rule):
    id = "shm-lifecycle"
    description = ("shared-memory segment created in a scope with no "
                   "unlink() on any shutdown path — the /dev/shm backing "
                   "outlives the process")

    @staticmethod
    def _creates_segment(call: ast.Call) -> bool:
        """``SharedMemory(create=True, ...)`` or ``ShmRing.create(...)``
        — the two ways this codebase mints a segment it then OWNS.
        ``SharedMemory(name=...)`` attachments are the peer side and
        must not unlink; they are never flagged."""
        if _terminal(call.func) == "SharedMemory":
            return any(kw.arg == "create" and
                       isinstance(kw.value, ast.Constant) and
                       kw.value.value is True for kw in call.keywords)
        return (_dotted(call.func) or "").endswith("ShmRing.create")

    def check(self, ctx: FileContext) -> List[Finding]:
        parents: Dict[int, ast.AST] = {}
        for node in ast.walk(ctx.tree):
            for child in ast.iter_child_nodes(node):
                parents[id(child)] = node

        def scope_of(node: ast.AST) -> ast.AST:
            """Nearest enclosing ClassDef, else the outermost
            FunctionDef, else the module — the region where the matching
            unlink for this segment would plausibly live (same rule as
            ``thread-shutdown``'s stop-path search)."""
            cur, outer_fn = node, None
            while id(cur) in parents:
                cur = parents[id(cur)]
                if isinstance(cur, ast.ClassDef):
                    return cur
                if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    outer_fn = cur
            return outer_fn if outer_fn is not None else ctx.tree

        findings = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call) and
                    self._creates_segment(node)):
                continue
            if self._has_unlink_path(scope_of(node)):
                continue
            findings.append(self.finding(
                ctx, node,
                "shared-memory segment created with no unlink() in scope "
                "— close() only drops the mapping; without the creator's "
                "unlink() the /dev/shm backing leaks until reboot.  "
                "Unlink on the shutdown path (or pass unlink=True to the "
                "channel teardown)"))
        return findings

    @staticmethod
    def _has_unlink_path(scope: ast.AST) -> bool:
        for node in ast.walk(scope):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "unlink":
                return True
            # delegated teardown: ShmChannel.close_rings(unlink=True)
            if any(kw.arg == "unlink" and
                   isinstance(kw.value, ast.Constant) and
                   kw.value.value is True for kw in node.keywords):
                return True
        return False


# ---------------------------------------------------------------------------
# wire-seam
# ---------------------------------------------------------------------------


class WireSeamRule(Rule):
    id = "wire-seam"
    description = ("raw socket recv()/sendall() outside ps/networking.py "
                   "— bypasses the zero-copy / fault-hook / byte-counter "
                   "wire seam")

    #: the methods that move bytes on a socket; attribute-call matching
    #: by name (the house style — bare-print, staleness-protocol), with
    #: the pragma as the escape hatch for a non-socket receiver
    _METHODS = ("recv", "recv_into", "sendall", "sendmsg")
    _SEAM = "ps/networking.py"

    def check(self, ctx: FileContext) -> List[Finding]:
        rel = ctx.rel.replace("\\", "/")
        if rel.endswith(self._SEAM) or rel == "networking.py":
            return []  # the seam itself is the one legitimate caller
        return [
            self.finding(
                ctx, node,
                f"raw socket .{node.func.attr}() outside ps/networking.py "
                "— every wire byte must travel the networking seam "
                "(v1/v2/shm/stream frame detection, the chaos fault "
                "hook, the net.* byte counters); use send_msg/recv_msg/"
                "send_packed/send_stream/recv_pull instead, or disable "
                "with a pragma if the receiver is not a socket")
            for node in ast.walk(ctx.tree)
            if isinstance(node, ast.Call) and
            isinstance(node.func, ast.Attribute) and
            node.func.attr in self._METHODS
        ]


# ---------------------------------------------------------------------------
# kv-version-guard
# ---------------------------------------------------------------------------


class KvVersionGuardRule(Rule):
    id = "kv-version-guard"
    description = ("PrefixCache.insert_remote() outside serve/kvfabric.py "
                   "— bypasses the checkpoint-version-stamped fabric seam "
                   "and can serve KV computed under different weights")

    #: attribute-call matching by name, the wire-seam pattern: the cache
    #: object's spelling varies (self._prefix, engine._prefix, cache)
    #: but the method name is the seam's contract
    _METHODS = ("insert_remote",)
    _SEAM = "serve/kvfabric.py"

    def check(self, ctx: FileContext) -> List[Finding]:
        rel = ctx.rel.replace("\\", "/")
        if rel.endswith(self._SEAM) or rel == "kvfabric.py":
            return []  # the version-guarded seam is the one caller
        return [
            self.finding(
                ctx, node,
                "remote KV inserted outside serve/kvfabric.py — "
                "insert_remote() may only be called by the fabric's "
                "admit_remote_entry seam, which checks the checkpoint "
                "version stamp before the insert AND re-checks it after "
                "(a stale push is refused, never joined); an insert "
                "elsewhere can serve KV computed under different "
                "weights, or disable with a pragma if the receiver is "
                "not a PrefixCache")
            for node in ast.walk(ctx.tree)
            if isinstance(node, ast.Call) and
            isinstance(node.func, ast.Attribute) and
            node.func.attr in self._METHODS
        ]


from .rules_project import PROJECT_RULES  # noqa: E402  (needs Rule above)

ALL_RULES: Tuple[Rule, ...] = (
    HotPathPurityRule(),
    LockDisciplineRule(),
    SwallowGuardRule(),
    ThreadShutdownRule(),
    BarePrintRule(),
    StalenessProtocolRule(),
    ShmLifecycleRule(),
    WireSeamRule(),
    KvVersionGuardRule(),
) + PROJECT_RULES

RULES_BY_ID: Dict[str, Rule] = {r.id: r for r in ALL_RULES}
