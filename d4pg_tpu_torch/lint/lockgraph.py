"""Interprocedural concurrency analysis: the lock graph.

Counterpart of ``d4pg_tpu/lint/lockgraph.py``. The 7th rule family
(``lock-order``) is purely syntactic — one function
body, ``with``/``acquire`` shapes. It cannot see an ABBA cycle that
spans a call (``_pop_ready`` holding the merge condition into a helper
that takes a ring lock, while a worker nests them the other way), nor a
shared counter mutated off its owning lock. This module is the
whole-program complement, families 8 and 9:

- ``lock-cycle`` — build a held-while-acquiring graph over EVERY module
  analyzed together: nodes are lock objects identified by attribute
  path (``self._commit_cond`` → ``_commit_cond``; ``ring._leaf_lock``
  and ``self._ring_locks[i]`` normalize the same way, so all shard
  conditions share one node — deliberately conservative), edges mean
  "some thread can acquire B while holding A", where the acquisition of
  B may be any number of calls deep (acquisition sets propagate through
  the call graph to a fixpoint). Any cycle — including a
  length-one cycle, a non-reentrant lock re-taken under itself — is a
  deadlock an interleaving can reach.
- ``unguarded-shared-write`` — for every attribute written outside
  ``__init__``, infer its owning lock from the majority of accesses:
  if all other reads/writes happen with some lock L held (directly, or
  inherited from every call site of the enclosing function), a write
  without L is flagged. Where inference is wrong or the caller holds
  the lock beyond what the analysis can see, declare it:
  ``# jaxlint: guarded-by=<lock>`` on the write line (or on the
  ``def`` line to cover a whole helper) asserts the contract instead
  of suppressing the rule.

Lock identity is by attribute NAME, not object — ``cond`` on any shard
is one node. That merges instances (all ring locks collapse), which is
exactly the right abstraction for ordering: the discipline "ring locks
are leaves" is a statement about the class of lock, not one instance.
Names are discovered from ``threading.Lock/RLock/Condition`` and
``core.locking.TieredLock/TieredCondition`` construction sites plus a
conservative name pattern (``*_lock``, ``*_locks``, ``cond``/``*_cond``,
``*_mutex``).

Call sites bind to program functions by bare name, as in the
reference, less three kinds of binding that Python never makes. The
port needs that: its ``DeviceStager.next``, ``RunLogger.log``, the
fleet's ``run`` methods and the fused chunks' ``uniform`` closures share
names with builtins, library functions and generator methods.

- A bare call spelled like a builtin (``next(it)``, ``set(...)``) is
  the builtin unless its module binds that name itself.
- A call on a module imported with ``import`` (``subprocess.run``,
  ``torch.log``, ``os.path.join``) binds only to the top-level functions
  of that module, when it is part of the program: never to a method.
- An attribute call (``rng.uniform(...)``) never binds to a def nested
  in a function's body: such a def is reachable only by its bare name.

``python -m d4pg_tpu_torch.lint --locks`` prints the discovered graph
(nodes, edges with witnesses, cycles) as a review artifact.
"""

from __future__ import annotations

import ast
import builtins
import re
from dataclasses import dataclass, field

from d4pg_tpu_torch.lint.context import (
    FunctionNode, ModuleContext, dotted_name, iter_defs, last_part,
)
from d4pg_tpu_torch.lint.findings import Finding

LOCK_RULES = ("lock-cycle", "unguarded-shared-write")

# Constructors whose assignment target becomes a known lock name.
_LOCK_CTORS = {"Lock", "RLock", "Condition", "TieredLock", "TieredCondition",
               "Semaphore", "BoundedSemaphore"}
# Fallback pattern for modules that only USE a lock they didn't build
# (and for fixtures): the receiver name itself says lock.
_LOCK_NAME = re.compile(
    r"(?:^|_)(?:lock|locks|cond|condition|mutex)$")
# Methods that operate ON a lock object — lock events or no-ops, never
# call-graph edges into same-named program functions.
_LOCK_METHODS = {"acquire", "release", "locked", "wait", "wait_for",
                 "notify", "notify_all"}
# Method names too generic to resolve by name across the program when
# they appear on a non-lock receiver AND collide with stdlib container
# APIs; resolution noise here would swamp the graph (``self._conns.add``
# is a set, not a replay buffer; ``self._skip.update`` is a set, not the
# obs normalizer).
_NO_RESOLVE = {"append", "appendleft", "extend", "popleft", "discard",
               "items", "keys", "values", "get", "setdefault", "join",
               "start", "put", "clear", "copy", "close", "set", "is_set",
               "add", "update", "remove", "insert", "count", "index",
               "sort", "wait"}
_MAX_CANDIDATES = 12

# Bare-name calls spelled like builtins are the builtin unless the module
# binds the name itself.
_BUILTIN_NAMES = frozenset(dir(builtins))

_GUARDED_BY = re.compile(r"#\s*jaxlint:\s*guarded-by=([\w\-,]+)")

_INIT_FNS = {"__init__", "__post_init__", "__new__", "__init_subclass__"}

# The declared attribute-path -> tier mapping for the sharded ingest
# plane (the same source of truth as core.locking.HIERARCHY; TieredLock
# construction sites override/extend it). Used for the leaf-ascent
# check: LEAF tiers (shard, ring) admit no further tiered acquisition —
# an edge out of a leaf into an equal-or-higher tier is the merge-wedge
# shape even when no full cycle (yet) closes it.
_DEFAULT_TIERS = {
    "_elastic_cond": "elastic",
    "_lock": "service",
    "_buffer_lock": "buffer",
    "_commit_cond": "commit",
    "_replica_lock": "replica",
    "_agg_cond": "agg",
    "_relay_lock": "wrelay",
    "_frame_lock": "wserve",
    "_pserve_cond": "pserve",
    "_store_lock": "wstore",
    "cond": "shard",
    "shard_lock": "shard",
    "_shard_locks": "shard",
    "_sampler_lock": "sampler",
    "_ring_locks": "ring",
    "ring_lock": "ring",
    "_leaf_lock": "ring",
}

# Static mirror of ``d4pg_tpu_torch.core.locking.HIERARCHY``. Mirrored,
# not imported: the lint imports only the standard library and nothing of
# the code it analyzes. tests/test_torch_lint_clean.py pins the two tables
# equal, so they cannot drift.
_TIER_VALUES = {"elastic": 60, "service": 50, "buffer": 40, "replica": 36,
                "agg": 34, "commit": 30, "wrelay": 28, "wserve": 26,
                "pserve": 25, "wstore": 24, "shard": 20, "sampler": 15,
                "ring": 10}


@dataclass
class _Acq:
    lock: str
    line: int
    col: int
    held: tuple[str, ...]
    path: str
    func: str


@dataclass
class _Call:
    callee: str
    recv_self: bool
    held: tuple[str, ...]
    line: int
    path: str
    func: str
    module: str | None = None  # dotted module a module-receiver call names
    attr: bool = False         # ``recv.m()``, not a bare ``m()``


@dataclass
class _Access:
    attr: str
    write: bool
    line: int
    col: int
    held: tuple[str, ...]
    path: str
    func: str  # qualified key of enclosing function ('' = module level)


@dataclass
class _FnInfo:
    key: str            # "<path>::<qualname>" — unique per program
    name: str           # bare name for call resolution
    cls: str | None
    path: str
    acqs: list[_Acq] = field(default_factory=list)
    calls: list[_Call] = field(default_factory=list)
    accesses: list[_Access] = field(default_factory=list)
    guards: tuple[str, ...] = ()  # guarded-by on the def line
    nested: bool = False  # defined in another function's body


def _lock_expr_name(expr: ast.expr, known: set[str]) -> str | None:
    """The lock node name for a with-item / acquire receiver, or None."""
    while isinstance(expr, ast.Subscript):
        expr = expr.value
    if isinstance(expr, ast.Call):
        return None
    name = last_part(dotted_name(expr) or "")
    if not name:
        return None
    if name in known or _LOCK_NAME.search(name):
        return name
    return None


def _guards_at(guard_lines: dict[int, tuple[str, ...]],
               node: ast.AST) -> tuple[str, ...]:
    out: tuple[str, ...] = ()
    for ln in range(node.lineno, (node.end_lineno or node.lineno) + 1):
        out += guard_lines.get(ln, ())
    return out


class _FunctionWalker:
    """One function body, statements in order, tracking the held-lock
    set through ``with`` nesting and bare ``acquire()`` calls (held to
    the end of the enclosing block — an over-approximation that matches
    the ``acquire/try/finally: release`` idiom)."""

    def __init__(self, info: _FnInfo, known: set[str],
                 guard_lines: dict[int, tuple[str, ...]], cls: str | None,
                 scope: "_ModuleScope"):
        self.info = info
        self.known = known
        self.guard_lines = guard_lines
        self.cls = cls
        self.scope = scope
        # ``commit = getattr(buf, "commit_staged", None)`` — later
        # ``commit()`` calls resolve to the string-named method, not to
        # every program function that happens to be named ``commit``
        self.aliases: dict[str, str] = {}

    def walk(self, body: list[ast.stmt]) -> None:
        self._block(body, ())

    # -- helpers -----------------------------------------------------------
    def _record_acq(self, lock: str, node: ast.AST,
                    held: tuple[str, ...]) -> None:
        self.info.acqs.append(_Acq(
            lock, node.lineno, node.col_offset, held,
            self.info.path, self.info.key))

    def _visit_expr(self, expr: ast.expr, held: tuple[str, ...],
                    acquired: list[tuple[str, str]]) -> None:
        """Record calls, lock events and attribute reads inside one
        expression. ``acquired`` collects (lock, dotted-path) pairs from
        bare ``.acquire()`` calls for block-scope held extension."""
        func_of_call: set[int] = set()
        lambdas: set[int] = set()
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                func_of_call.add(id(node.func))
            if isinstance(node, ast.Lambda):
                for inner in ast.walk(node):
                    if inner is not node:
                        lambdas.add(id(inner))
        for node in ast.walk(expr):
            if id(node) in lambdas:
                continue
            if isinstance(node, ast.Call):
                self._visit_call(node, held, acquired)
            elif (isinstance(node, ast.Attribute)
                    and isinstance(node.ctx, ast.Load)
                    and id(node) not in func_of_call):
                self.info.accesses.append(_Access(
                    node.attr, False, node.lineno, node.col_offset,
                    held + _guards_at(self.guard_lines, node),
                    self.info.path, self.info.key))

    def _visit_call(self, call: ast.Call, held: tuple[str, ...],
                    acquired: list[tuple[str, str]]) -> None:
        f = call.func
        if isinstance(f, ast.Attribute):
            recv_lock = _lock_expr_name(f.value, self.known)
            if f.attr in _LOCK_METHODS:
                if recv_lock is not None:
                    if f.attr == "acquire":
                        path_str = dotted_name(f.value) or recv_lock
                        # a retry of the SAME dotted path (nonblocking
                        # probe then blocking acquire) is one logical
                        # acquisition, not self-nesting
                        if (recv_lock, path_str) not in acquired:
                            self._record_acq(recv_lock, call, held)
                            if recv_lock not in held:
                                acquired.append((recv_lock, path_str))
                    return  # wait/notify/release on a lock: not a call
                if f.attr in {"acquire", "release"}:
                    return  # unknown receiver named like a lock method
            if f.attr in _NO_RESOLVE or f.attr.startswith("__"):
                return
            recv_self = (isinstance(f.value, ast.Name)
                         and f.value.id == "self")
            self.info.calls.append(_Call(
                f.attr, recv_self, held, call.lineno,
                self.info.path, self.info.key,
                self.scope.module_of(f.value), attr=True))
        elif isinstance(f, ast.Name):
            if (f.id in _BUILTIN_NAMES and f.id not in self.aliases
                    and f.id not in self.scope.bound):
                return  # the builtin: no program function runs
            self.info.calls.append(_Call(
                self.aliases.get(f.id, f.id), False, held, call.lineno,
                self.info.path, self.info.key))

    def _record_write_target(self, target: ast.expr,
                             held: tuple[str, ...]) -> None:
        # self.x = / obj.x += / self.d[k] = — all writes to attribute x/d
        node = target
        if isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Attribute):
            self.info.accesses.append(_Access(
                node.attr, True, node.lineno, node.col_offset,
                held + _guards_at(self.guard_lines, target),
                self.info.path, self.info.key))
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._record_write_target(elt, held)

    # -- statement driver --------------------------------------------------
    def _block(self, body: list[ast.stmt], held: tuple[str, ...]) -> None:
        acquired: list[tuple[str, str]] = []  # bare-acquire extensions
        for stmt in body:
            eff = held + tuple(l for l, _ in acquired if l not in held)
            self._stmt(stmt, eff, acquired)

    def _stmt(self, stmt: ast.stmt, held: tuple[str, ...],
              acquired: list[tuple[str, str]]) -> None:
        if isinstance(stmt, FunctionNode + (ast.ClassDef,)):
            return  # separate scope: walked as its own _FnInfo
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            inner = held
            for item in stmt.items:
                lock = _lock_expr_name(item.context_expr, self.known)
                self._visit_expr(item.context_expr, inner, acquired)
                if lock is not None:
                    self._record_acq(lock, item.context_expr, inner)
                    if lock not in inner:
                        inner = inner + (lock,)
            self._block(stmt.body, inner)
            return
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            if stmt.value is not None:
                self._visit_expr(stmt.value, held, acquired)
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and isinstance(stmt.value, ast.Call)
                    and isinstance(stmt.value.func, ast.Name)
                    and stmt.value.func.id == "getattr"
                    and len(stmt.value.args) >= 2
                    and isinstance(stmt.value.args[1], ast.Constant)
                    and isinstance(stmt.value.args[1].value, str)):
                self.aliases[stmt.targets[0].id] = stmt.value.args[1].value
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for t in targets:
                self._record_write_target(t, held)
                # subscripted/attribute targets also READ their base
                if isinstance(t, ast.Subscript):
                    self._visit_expr(t.slice, held, acquired)
            if isinstance(stmt, ast.AugAssign) and isinstance(
                    stmt.target, ast.Attribute):
                pass  # covered by _record_write_target
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._visit_expr(stmt.iter, held, acquired)
            self._block(stmt.body, held)
            self._block(stmt.orelse, held)
            return
        if isinstance(stmt, ast.While):
            self._visit_expr(stmt.test, held, acquired)
            self._block(stmt.body, held)
            self._block(stmt.orelse, held)
            return
        if isinstance(stmt, ast.If):
            self._visit_expr(stmt.test, held, acquired)
            self._block(stmt.body, held)
            self._block(stmt.orelse, held)
            return
        if isinstance(stmt, ast.Try):
            self._block(stmt.body, held)
            for h in stmt.handlers:
                self._block(h.body, held)
            self._block(stmt.orelse, held)
            self._block(stmt.finalbody, held)
            return
        # leaf statements: Expr, Return, Raise, Assert, Delete, ...
        for value in ast.iter_child_nodes(stmt):
            if isinstance(value, ast.expr):
                self._visit_expr(value, held, acquired)


# --------------------------------------------------------------------------
# program assembly
# --------------------------------------------------------------------------


@dataclass
class LockGraph:
    """The artifact ``--locks`` prints and the rules consume."""

    nodes: dict[str, str | None] = field(default_factory=dict)  # name->tier
    # (held, acquired) -> list of witness strings "path:line (func)"
    edges: dict[tuple[str, str], list[str]] = field(default_factory=dict)
    cycles: list[list[str]] = field(default_factory=list)
    findings: list[Finding] = field(default_factory=list)
    functions: int = 0


def _collect_lock_names(trees: list[tuple[str, ast.Module]]
                        ) -> tuple[set[str], dict[str, str]]:
    """Program-wide lock names + tier-name labels from TieredLock ctors."""
    names: set[str] = set()
    tiers: dict[str, str] = {}

    def ctor_of(value: ast.expr) -> ast.Call | None:
        if isinstance(value, (ast.ListComp, ast.GeneratorExp)):
            value = value.elt
        if (isinstance(value, ast.Call)
                and last_part(dotted_name(value.func) or "") in _LOCK_CTORS):
            return value
        return None

    for _path, tree in trees:
        for node in ast.walk(tree):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            value = node.value
            if value is None:
                continue
            call = ctor_of(value)
            if call is None:
                continue
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                name = None
                if isinstance(t, ast.Attribute):
                    name = t.attr
                elif isinstance(t, ast.Name):
                    name = t.id
                if name is None:
                    continue
                names.add(name)
                if (last_part(dotted_name(call.func) or "")
                        in {"TieredLock", "TieredCondition"}
                        and call.args
                        and isinstance(call.args[0], ast.Constant)
                        and isinstance(call.args[0].value, str)):
                    tiers[name] = call.args[0].value
    return names, tiers


def _guard_lines_of(source: str) -> dict[int, tuple[str, ...]]:
    out: dict[int, tuple[str, ...]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _GUARDED_BY.search(text)
        if m:
            out[i] = tuple(r.strip() for r in m.group(1).split(",")
                           if r.strip())
    return out


@dataclass
class _ModuleScope:
    """What one module binds: every name it binds itself (imports, defs
    outside classes, module-level assignments) and the local aliases of
    the modules it imports with ``import x`` / ``import x.y as z``."""

    bound: set[str] = field(default_factory=set)
    modules: dict[str, str] = field(default_factory=dict)  # alias -> dotted

    @classmethod
    def of(cls, tree: ast.Module) -> "_ModuleScope":
        scope = cls()

        def walk(node: ast.AST, in_class: bool) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.Import):
                    for a in child.names:
                        local = a.asname or a.name.split(".", 1)[0]
                        scope.bound.add(local)
                        scope.modules[local] = a.name if a.asname else local
                elif isinstance(child, ast.ImportFrom):
                    scope.bound.update(a.asname or a.name
                                       for a in child.names)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef,
                                        ast.ClassDef)) and not in_class:
                    scope.bound.add(child.name)
                walk(child, isinstance(child, ast.ClassDef))

        walk(tree, False)
        for stmt in tree.body:
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                scope.bound.update(t.id for t in targets
                                   if isinstance(t, ast.Name))
        return scope

    def module_of(self, recv: ast.expr) -> str | None:
        """The dotted module a call receiver names (``torch`` for
        ``torch.log``, ``os.path`` for ``os.path.join``), else None."""
        dotted = dotted_name(recv)
        if dotted is None:
            return None
        root, _, rest = dotted.partition(".")
        if root not in self.modules:
            return None
        return self.modules[root] + (f".{rest}" if rest else "")


def build_program(ctxs: list[ModuleContext]) -> tuple[
        list[_FnInfo], set[str], dict[str, str]]:
    trees = [(c.path, c.tree) for c in ctxs]
    known, tiers = _collect_lock_names(trees)
    infos: list[_FnInfo] = []
    for ctx in ctxs:
        guard_lines = _guard_lines_of(ctx.source)
        scope = _ModuleScope.of(ctx.tree)
        for node, qual, cls in iter_defs(ctx.tree):
            info = _FnInfo(
                key=f"{ctx.path}::{qual}", name=node.name, cls=cls,
                path=ctx.path,
                guards=guard_lines.get(node.lineno, ()),
                nested=ctx.parents.get(node) is not None)
            walker = _FunctionWalker(info, known, guard_lines, cls, scope)
            walker.walk(node.body)
            infos.append(info)
        # module-level statements get a pseudo-function
        mod_stmts = [s for s in ctx.tree.body
                     if not isinstance(s, FunctionNode + (ast.ClassDef,))]
        if mod_stmts:
            info = _FnInfo(key=f"{ctx.path}::<module>", name="<module>",
                           cls=None, path=ctx.path)
            _FunctionWalker(info, known, guard_lines, None,
                            scope).walk(mod_stmts)
            infos.append(info)
    return infos, known, tiers


def _defines_module(path: str, module: str) -> bool:
    """Whether the file at ``path`` is the module ``module`` names."""
    stem = path.replace("\\", "/")[:-len(".py")]
    if stem.endswith("/__init__"):
        stem = stem[:-len("/__init__")]
    mod = module.replace(".", "/")
    return stem == mod or stem.endswith("/" + mod)


def _resolve(call: _Call, caller: _FnInfo,
             by_name: dict[str, list[_FnInfo]],
             by_class: dict[tuple[str | None, str], list[_FnInfo]]
             ) -> list[_FnInfo]:
    """Candidate callees for one call site. ``self.m()`` binds to the
    caller's own class when it defines ``m``; other receivers resolve by
    bare name across the program, EXCLUDING the caller's own class (a
    same-class method would have been written ``self.m()``) and bailing
    out when the name is too popular to mean anything. An attribute call
    never binds to a function nested in another function's body (such a
    def is reachable only by its bare name), and a call on an imported
    module binds only to that module's top-level functions."""
    if call.module is not None:
        return [f for f in by_name.get(call.callee, ())
                if f.cls is None and "." not in _short(f.key)
                and _defines_module(f.path, call.module)]
    if call.recv_self and caller.cls is not None:
        own = by_class.get((caller.cls, call.callee))
        if own:
            return own
    cands = [f for f in by_name.get(call.callee, ())
             if not (call.recv_self is False and caller.cls is not None
                     and f.cls == caller.cls and f.path == caller.path)
             and not (call.attr and f.nested)]
    if len(cands) > _MAX_CANDIDATES:
        return []
    return cands


def analyze(ctxs: list[ModuleContext],
            rules: list[str] | None = None) -> LockGraph:
    """Run the whole-program pass; ``rules`` filters which families emit
    findings (both always contribute to the printed graph)."""
    infos, known, tiers = build_program(ctxs)
    graph = LockGraph(functions=len(infos))
    graph.nodes = {}

    by_name: dict[str, list[_FnInfo]] = {}
    by_class: dict[tuple[str | None, str], list[_FnInfo]] = {}
    for f in infos:
        by_name.setdefault(f.name, []).append(f)
        by_class.setdefault((f.cls, f.name), []).append(f)

    resolved: dict[str, list[tuple[_Call, list[_FnInfo]]]] = {}
    for f in infos:
        resolved[f.key] = [(c, _resolve(c, f, by_name, by_class))
                           for c in f.calls]

    # ---- acquisition closure (fixpoint over the resolved calls) ---------
    closure: dict[str, set[str]] = {
        f.key: {a.lock for a in f.acqs} for f in infos}
    changed = True
    while changed:
        changed = False
        for f in infos:
            acc = closure[f.key]
            before = len(acc)
            for _call, cands in resolved[f.key]:
                for g in cands:
                    acc |= closure[g.key]
            if len(acc) != before:
                changed = True

    # ---- held-while-acquiring edges -------------------------------------
    def add_edge(a: str, b: str, witness: str) -> None:
        graph.edges.setdefault((a, b), [])
        if len(graph.edges[(a, b)]) < 4:
            graph.edges[(a, b)].append(witness)

    anchor: dict[tuple[str, str], _Acq | _Call] = {}
    for f in infos:
        for acq in f.acqs:
            graph.nodes.setdefault(acq.lock, tiers.get(acq.lock))
            for h in acq.held:
                if h == acq.lock:
                    continue  # same-name nesting under a with is covered
                              # by lock-order's leaf analysis; keep the
                              # interprocedural graph for cross-name order
                add_edge(h, acq.lock,
                         f"{f.path}:{acq.line} ({_short(f.key)})")
                anchor.setdefault((h, acq.lock), acq)
        for call, cands in resolved[f.key]:
            if not call.held:
                continue
            for g in cands:
                for b in closure[g.key]:
                    for h in call.held:
                        if h == b:
                            continue
                        add_edge(h, b,
                                 f"{f.path}:{call.line} "
                                 f"({_short(f.key)} -> {_short(g.key)})")
                        anchor.setdefault((h, b), call)
    for h, _t in list(graph.edges):
        graph.nodes.setdefault(h, tiers.get(h))

    # ---- cycles ---------------------------------------------------------
    graph.cycles = _find_cycles(graph.edges)
    want = set(rules) if rules is not None else {"lock-cycle",
                                                "unguarded-shared-write"}
    if "lock-cycle" in want:
        cycle_edges = {
            (cyc[i], cyc[(i + 1) % len(cyc)])
            for cyc in graph.cycles for i in range(len(cyc))}
        # leaf-tier ascent: holding a shard/ring leaf while acquiring an
        # equal-or-higher declared tier — the merge-wedge shape — is a
        # finding even before a reverse edge closes a full cycle. Edges
        # already inside a reported cycle are not double-reported.
        tiers = dict(_DEFAULT_TIERS)
        tiers.update({k: v for k, v in graph.nodes.items() if v})
        tval = _TIER_VALUES
        leaf_floor = tval.get("shard", 20)
        for (h, b), wits in sorted(graph.edges.items()):
            th, tb = tval.get(tiers.get(h, "")), tval.get(tiers.get(b, ""))
            if th is None or tb is None or (h, b) in cycle_edges:
                continue
            if th <= leaf_floor and tb >= th:
                site = anchor[(h, b)]
                graph.findings.append(Finding(
                    site.path, site.line, getattr(site, "col", 0),
                    "lock-cycle",
                    f"'{b}' ({tiers.get(b)} tier) acquired while holding "
                    f"leaf-tier '{h}' ({tiers.get(h)}) at {wits[0]} — "
                    "shard/ring locks admit no further tiered "
                    "acquisition (the merge-wedge shape); release "
                    "the leaf first (core.locking.HIERARCHY)"))
        for cyc in graph.cycles:
            a, b = cyc[0], cyc[1 % len(cyc)]
            site = anchor.get((a, b)) or anchor.get((b, a))
            path_desc = " -> ".join(cyc + [cyc[0]])
            hops = []
            for i, x in enumerate(cyc):
                y = cyc[(i + 1) % len(cyc)]
                wit = graph.edges.get((x, y), ["?"])[0]
                hops.append(f"'{x}'->'{y}' at {wit}")
            graph.findings.append(Finding(
                site.path if site is not None else ctxs[0].path,
                site.line if site is not None else 1,
                getattr(site, "col", 0) if site is not None else 0,
                "lock-cycle",
                f"lock cycle {path_desc}: " + "; ".join(hops)
                + " — some interleaving deadlocks here; acquire these "
                "locks in one declared order (core.locking.HIERARCHY)"))

    if "unguarded-shared-write" in want:
        graph.findings.extend(
            _unguarded_writes(infos, resolved, known))

    graph.findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return graph


def _short(key: str) -> str:
    return key.rsplit("::", 1)[-1]


def _find_cycles(edges: dict[tuple[str, str], list[str]]) -> list[list[str]]:
    """Elementary cycles via SCC + per-SCC DFS (graphs here are tiny).
    Self-loops come out as single-node cycles."""
    adj: dict[str, set[str]] = {}
    for (a, b) in edges:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set())
    # Tarjan SCC
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on: set[str] = set()
    stack: list[str] = []
    sccs: list[list[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        work = [(v, iter(sorted(adj[v])))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(adj[w]))))
                    advanced = True
                    break
                elif w in on:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                sccs.append(comp)

    for v in sorted(adj):
        if v not in index:
            strongconnect(v)

    cycles: list[list[str]] = []
    for comp in sccs:
        comp_set = set(comp)
        if len(comp) == 1:
            v = comp[0]
            if v in adj.get(v, ()):  # self-loop
                cycles.append([v])
            continue
        # one representative cycle per SCC: walk from the smallest node
        start = min(comp)
        path = [start]
        seen = {start}
        cur = start
        while True:
            nxts = [w for w in sorted(adj[cur]) if w in comp_set]
            nxt = next((w for w in nxts if w == start), None)
            if nxt is not None and len(path) > 1:
                break
            nxt = next((w for w in nxts if w not in seen), None)
            if nxt is None:
                # fall back: close through any in-SCC successor
                break
            path.append(nxt)
            seen.add(nxt)
            cur = nxt
        cycles.append(path)
    return cycles


def _unguarded_writes(infos: list[_FnInfo],
                      resolved: dict[str, list[tuple[_Call, list[_FnInfo]]]],
                      known: set[str]) -> list[Finding]:
    by_key = {f.key: f for f in infos}

    # ---- inherited held context: ∩ over call sites of (site-held ∪
    # caller-inherited); entry points (no resolved callers) inherit {}.
    sites: dict[str, list[tuple[str, tuple[str, ...]]]] = {}
    for f in infos:
        for call, cands in resolved[f.key]:
            for g in cands:
                sites.setdefault(g.key, []).append((f.key, call.held))
    TOP = frozenset(known) | {"<top>"}
    inherited: dict[str, frozenset] = {
        f.key: (TOP if f.key in sites else frozenset()) for f in infos}
    changed = True
    iters = 0
    while changed and iters < 50:
        changed = False
        iters += 1
        for f in infos:
            cur = inherited[f.key]
            if f.key not in sites:
                continue
            acc = None
            for caller_key, held in sites[f.key]:
                eff = frozenset(held) | inherited.get(caller_key,
                                                     frozenset())
                acc = eff if acc is None else (acc & eff)
            acc = acc if acc is not None else frozenset()
            if acc != cur:
                inherited[f.key] = acc
                changed = True

    # ---- group accesses by attribute ------------------------------------
    per_attr: dict[str, list[tuple[_Access, frozenset]]] = {}
    writers: set[str] = set()
    for f in infos:
        base = frozenset(f.guards) | (inherited[f.key] - {"<top>"})
        in_init = _short(f.key).split(".")[-1] in _INIT_FNS
        for a in f.accesses:
            if a.attr in known or a.attr.startswith("__"):
                continue
            if in_init:
                continue  # construction is single-threaded
            eff = frozenset(a.held) | base
            per_attr.setdefault(a.attr, []).append((a, eff))
            if a.write:
                writers.add(a.attr)

    findings: list[Finding] = []
    for attr, accesses in per_attr.items():
        if attr not in writers:
            continue
        if len(accesses) < 3:
            continue  # too few sites to infer ownership
        # candidate owner: the lock held at the most accesses
        counts: dict[str, int] = {}
        for _a, eff in accesses:
            for lock in eff:
                counts[lock] = counts.get(lock, 0) + 1
        if not counts:
            continue
        owner = max(sorted(counts), key=lambda k: counts[k])
        covered = [x for x in accesses if owner in x[1]]
        uncovered = [x for x in accesses if owner not in x[1]]
        if not uncovered or len(covered) < 2:
            continue
        # "elsewhere only touched under the lock": every access we are
        # NOT flagging holds the owner — unguarded reads elsewhere mean
        # the attribute isn't lock-owned (single-writer patterns), so
        # stay silent rather than guess.
        if any(not a.write for a, _ in uncovered):
            continue
        if len(uncovered) >= len(covered):
            continue
        sample = covered[0][0]
        for a, _eff in uncovered:
            findings.append(Finding(
                a.path, a.line, a.col, "unguarded-shared-write",
                f"write to '{attr}' without holding '{owner}' — "
                f"{len(covered)} of {len(accesses)} accesses hold it "
                f"(e.g. {sample.path}:{sample.line}); take the lock, or "
                f"declare the caller's contract with "
                f"`# jaxlint: guarded-by={owner}`"))
    return findings


# --------------------------------------------------------------------------
# review artifact (CLI --locks)
# --------------------------------------------------------------------------


def format_graph(graph: LockGraph) -> str:
    lines = [f"lock graph: {len(graph.nodes)} lock(s), "
             f"{len(graph.edges)} held-while-acquiring edge(s), "
             f"{len(graph.cycles)} cycle(s) over {graph.functions} "
             f"function(s)"]
    lines.append("nodes:")
    for name in sorted(graph.nodes):
        tier = graph.nodes[name]
        lines.append(f"  {name}" + (f"  [tier: {tier}]" if tier else ""))
    lines.append("edges (held -> acquired):")
    for (a, b) in sorted(graph.edges):
        wits = graph.edges[(a, b)]
        lines.append(f"  {a} -> {b}   ({wits[0]}"
                     + (f" +{len(wits) - 1} more" if len(wits) > 1 else "")
                     + ")")
    if graph.cycles:
        lines.append("cycles:")
        for cyc in graph.cycles:
            lines.append("  " + " -> ".join(cyc + [cyc[0]]))
    else:
        lines.append("cycles: none")
    return "\n".join(lines)
