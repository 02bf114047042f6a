"""Module-level analysis context shared by every lint rule.

Counterpart of ``d4pg_tpu/lint/context.py``. The reference's context
also answers "does this code run under a JAX trace?" for its JAX-only
families; none of those families is carried into the port, so this
context keeps only what the carried ones read: the parsed module, its
source text (for the ``# jaxlint:`` annotations), each function's
enclosing function, and the def index the whole-program passes resolve
call sites against.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

FunctionNode = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def dotted_name(node: ast.AST) -> str | None:
    """'os.path.join' for an Attribute chain, 'join' for a Name, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def last_part(dotted: str | None) -> str | None:
    return dotted.rsplit(".", 1)[-1] if dotted else None


@dataclass
class ModuleContext:
    path: str
    source: str
    tree: ast.Module
    # every FunctionDef/Lambda -> its immediate parent function (or None)
    parents: dict[ast.AST, ast.AST | None] = field(default_factory=dict)


def iter_defs(tree: ast.Module):
    """Yield ``(node, qualname, class_name)`` for every function/method in
    a module — the def index the whole-program passes (``lockgraph``,
    ``wiregraph``, ``failgraph``, ``rnggraph``) resolve call sites
    against. Lambdas are skipped (they cannot be called by name across
    functions); ``qualname`` is dotted through enclosing classes and
    functions."""
    def walk(node, prefix: str, cls: str | None):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                yield child, qual, cls
                yield from walk(child, qual + ".", cls)
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.", child.name)
            elif not isinstance(child, ast.Lambda):
                yield from walk(child, prefix, cls)

    yield from walk(tree, "", None)


def build_context(path: str, source: str) -> ModuleContext:
    ctx = ModuleContext(path=path, source=source,
                        tree=ast.parse(source, filename=path))

    def index(node: ast.AST, parent_func: ast.AST | None) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, FunctionNode):
                ctx.parents[child] = parent_func
                index(child, child)
            else:
                index(child, parent_func)

    index(ctx.tree, None)
    return ctx
