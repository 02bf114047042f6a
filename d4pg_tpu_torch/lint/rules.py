"""The jaxlint rule catalog of the port.

Counterpart of ``d4pg_tpu/lint/rules.py``. Thirteen rule families, the
reference's framework-neutral ones, with the reference's ids:

- ``lock-order``           — service/buffer lock acquired under a shard lock
- ``lock-cycle``           — interprocedural ABBA cycle in the lock graph
- ``unguarded-shared-write`` — shared attribute mutated off its owning lock
- ``wire-magic-registry``  — frame magic/flag bit outside the declared table
- ``codec-asymmetry``      — pack/unpack format or field-count drift
- ``unchecked-frame``      — recv-rooted decode without error/crc containment
- ``flag-bit-collision``   — one flag-byte bit claimed by two extensions
- ``thread-crash-containment`` — Thread target that can die uncaught (or
  caught-but-uncounted); ``# jaxlint: contained-by=<handler>`` declares
  an audited wrapper
- ``span-terminal-missing`` — trace begin with an exception-edge path to
  exit that never reaches a commit/shed terminal
- ``ledger-conservation``  — admission-counter bump whose path to exit
  records no disposition and no hand-off
- ``rng-ambient-stream``   — numpy/stdlib global-RNG draw, unseeded
  ctor, or wall-clock seed inside determinism-scoped code
- ``rng-stream-thread-escape`` — one Generator drawn from two
  thread-spawn targets without its own SeedSequence branch;
  ``# jaxlint: stream-owner=<Component.attr>`` declares a caller-owned
  branch
- ``rng-draw-count-drift`` — seeded stream drawn a path-dependent
  count per event; only skip-before-RNG-use is clean

``lock-order`` is per-module. The other twelve are PROGRAM-scope
families implemented in ``lint/lockgraph.py`` (locks),
``lint/wiregraph.py`` (wire protocol), ``lint/failgraph.py`` (exception
flow / ledger) and ``lint/rnggraph.py`` (RNG provenance): they analyze
every module of a lint run together (cross-module call graph).

The reference's other eleven families (``prng-key-reuse``,
``host-sync-in-jit``, ``recompile-hazard``, ``use-after-donation``,
``tracer-leak``, ``device-put-in-loop``, ``host-time-in-jit``,
``sharding-rule-bypass``, ``collective-axis-unbound``,
``sharding-spec-drift``, ``donation-alias``) read ``jax.jit``,
``donate_argnums``, ``jax.random``, ``device_put``, ``shard_map`` or
``NamedSharding``, none of which the port has; they are not carried.

Every rule is a function ``(ModuleContext) -> list[Finding]`` registered in
``RULES``. Rules are deliberately conservative: a finding should be either
a true positive or a line whose suppression comment is itself useful
documentation.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

from d4pg_tpu_torch.lint import failgraph, lockgraph, rnggraph, wiregraph
from d4pg_tpu_torch.lint.context import (
    FunctionNode, ModuleContext, dotted_name, last_part,
)
from d4pg_tpu_torch.lint.findings import Finding

# --------------------------------------------------------------------------
# shared AST helpers
# --------------------------------------------------------------------------


def walk_own(node: ast.AST):
    """Walk ``node``'s subtree WITHOUT descending into nested functions —
    each function is analyzed in its own pass."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, FunctionNode):
            continue
        yield child
        yield from walk_own(child)


def all_functions(ctx: ModuleContext):
    for node in ast.walk(ctx.tree):
        if isinstance(node, FunctionNode):
            yield node


def _body_of(func: ast.AST) -> list[ast.stmt]:
    if isinstance(func, ast.Lambda):
        return [ast.Expr(value=func.body)]
    return func.body


# --------------------------------------------------------------------------
# R7: lock-order
# --------------------------------------------------------------------------

# The sharded ingest plane's locking discipline (distributed/
# replay_service.py): shard/ring locks are LEAF locks. The commit thread
# holds the buffer or service lock and may wait for shard work to land;
# a thread that takes the buffer/service lock while already inside a
# shard/ring lock closes the classic ABBA cycle. Tiers by attribute name
# (conservative: only these exact suffixes participate):
_LEAF_LOCKS = {"cond", "_cond", "ring_lock", "shard_lock", "_ring_locks",
               "_shard_locks"}
_OUTER_LOCKS = {"_buffer_lock", "_lock", "_commit_cond"}


def _lock_tier(expr: ast.expr) -> str | None:
    """'leaf' / 'outer' / None for a with-item or .acquire() receiver."""
    # unwrap subscripts: with self._ring_locks[i]: ...
    while isinstance(expr, ast.Subscript):
        expr = expr.value
    name = last_part(dotted_name(expr) or "")
    if name in _LEAF_LOCKS:
        return "leaf"
    if name in _OUTER_LOCKS:
        return "outer"
    return None


def rule_lock_order(ctx: ModuleContext) -> list[Finding]:
    """Flags acquiring a buffer/service-tier lock while holding a
    shard/ring-tier (leaf) lock — the deadlock shape of the sharded
    ingest plane. Detects both ``with`` nesting and bare ``.acquire()``
    calls lexically inside a leaf ``with`` block, within one function
    (cross-function flows are ``lock-cycle``'s)."""
    findings: list[Finding] = []

    def emit(node, held: str):
        findings.append(Finding(
            ctx.path, node.lineno, node.col_offset, "lock-order",
            f"outer-tier lock acquired while holding leaf lock '{held}' — "
            "shard/ring locks are leaf locks; take the buffer/service "
            "lock first or split the critical section"))

    def scan(body: list[ast.stmt], held: str | None) -> None:
        for stmt in body:
            inner_held = held
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    tier = _lock_tier(item.context_expr)
                    if tier == "outer" and held is not None:
                        emit(item.context_expr, held)
                    elif tier == "leaf":
                        nm = last_part(
                            dotted_name(
                                item.context_expr.value
                                if isinstance(item.context_expr,
                                              ast.Subscript)
                                else item.context_expr) or "")
                        inner_held = nm or "leaf"
                scan(stmt.body, inner_held)
                continue
            if isinstance(stmt, FunctionNode):
                continue  # new scope, analyzed by its own pass
            if held is not None:
                for node in walk_own(stmt):
                    if (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Attribute)
                            and node.func.attr == "acquire"
                            and _lock_tier(node.func.value) == "outer"):
                        emit(node, held)
            # generic recursion into compound statements
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr, None)
                if isinstance(sub, list) and sub \
                        and isinstance(sub[0], ast.stmt):
                    scan(sub, held)
            for handler in getattr(stmt, "handlers", []) or []:
                scan(handler.body, held)

    for func in all_functions(ctx):
        scan(_body_of(func), None)
    scan([s for s in ctx.tree.body if not isinstance(s, FunctionNode)], None)
    return findings


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Rule:
    id: str
    summary: str
    check: object  # (ModuleContext) -> list[Finding]
    # 'module' rules see one file at a time; 'program' rules run ONCE over
    # every analyzed module together — the engine dispatches them to
    # their graph pass instead of the per-file loop.
    scope: str = "module"


def _graph_rule(graph, rule_id: str):
    """Single-module fallback so ``Rule.check`` drives a program family
    on one module; whole trees go through ``engine.lint_paths``'s
    one-shot program pass."""
    def check(ctx: ModuleContext) -> list[Finding]:
        return graph.analyze([ctx], rules=[rule_id]).findings

    return check


RULES: dict[str, Rule] = {r.id: r for r in [
    Rule("lock-order",
         "buffer/service lock acquired while holding a shard/ring leaf "
         "lock — the sharded-ingest deadlock shape",
         rule_lock_order),
    Rule("lock-cycle",
         "cycle in the interprocedural held-while-acquiring lock graph "
         "(ABBA across any number of calls) — see lint/lockgraph.py",
         _graph_rule(lockgraph, "lock-cycle"), scope="program"),
    Rule("unguarded-shared-write",
         "attribute written without the lock every other access holds "
         "(ownership inferred; declare `# jaxlint: guarded-by=<lock>`)",
         _graph_rule(lockgraph, "unguarded-shared-write"),
         scope="program"),
    Rule("wire-magic-registry",
         "0xD4xx magic or flag bit packed into a frame but absent from / "
         "re-declared outside the declared registry (core/wire.py); "
         "seed-derivation literals are exempt",
         _graph_rule(wiregraph, "wire-magic-registry"), scope="program"),
    Rule("codec-asymmetry",
         "pack/unpack format not a field segment of its magic's declared "
         "header, arg/target count drift, *_SIZE constant != calcsize, or "
         "a magic packed but never unpacked",
         _graph_rule(wiregraph, "codec-asymmetry"), scope="program"),
    Rule("unchecked-frame",
         "socket-facing decode (recv -> unpack/np.load/np.frombuffer) "
         "without struct.error/ValueError containment, or payload use "
         "before the declared crc32 check",
         _graph_rule(wiregraph, "unchecked-frame"), scope="program"),
    Rule("flag-bit-collision",
         "two extensions claiming the same bit of the same plane's flag "
         "byte — see core/wire.py for the allocations",
         _graph_rule(wiregraph, "flag-bit-collision"), scope="program"),
    Rule("thread-crash-containment",
         "threading.Thread target that can die on an uncaught raise, or "
         "whose broad handler swallows the crash uncounted — declare "
         "`# jaxlint: contained-by=<handler>` for wrapped targets",
         _graph_rule(failgraph, "thread-crash-containment"),
         scope="program"),
    Rule("span-terminal-missing",
         "trace begin whose exception edges can exit the frame without a "
         "commit/shed terminal — the static zero-orphan invariant",
         _graph_rule(failgraph, "span-terminal-missing"),
         scope="program"),
    Rule("ledger-conservation",
         "frame-admission counter bump with a path to exit that records "
         "neither a disposition counter nor a terminal hand-off",
         _graph_rule(failgraph, "ledger-conservation"), scope="program"),
    Rule("rng-ambient-stream",
         "numpy module-level global draw, stdlib random.* draw, "
         "unseeded default_rng()/RandomState(), or wall-clock-derived "
         "seed reachable from determinism-scoped code (fleet/chaos/"
         "traffic/sampler/ledger paths)",
         _graph_rule(rnggraph, "rng-ambient-stream"), scope="program"),
    Rule("rng-stream-thread-escape",
         "one Generator drawn from two distinct thread-spawn targets "
         "without its own SeedSequence branch — declare "
         "`# jaxlint: stream-owner=<Component.attr>` for caller-owned "
         "branches",
         _graph_rule(rnggraph, "rng-stream-thread-escape"),
         scope="program"),
    Rule("rng-draw-count-drift",
         "seeded stream drawn a path-dependent count per event — the "
         "backpressure desync shape; clean only under the documented "
         "skip-before-RNG-use idiom",
         _graph_rule(rnggraph, "rng-draw-count-drift"), scope="program"),
]}
