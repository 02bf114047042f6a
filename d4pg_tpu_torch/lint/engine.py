"""jaxlint driver: file discovery, rule execution, suppression filtering.

Counterpart of ``d4pg_tpu/lint/engine.py``. Two rule scopes
(``rules.Rule.scope``): *module* rules run per file, the *program*
families run ONCE over every parsed module of the invocation so
cross-module call edges (``replay_service`` into ``staging``) and import
chains (plane modules into ``core/wire.py``) exist. Each program family
belongs to one graph pass (``PASSES``): the lock graph, the wire
registry, the exception-flow graph and the RNG provenance graph.
``lint_source`` treats its single module as a whole program, which is
what the fixture tests drive.

Each pass runs at most once per invocation: ``lint_tree`` parses the
files once and hands the same graphs to the findings list and to the
``--all`` review artifacts.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from d4pg_tpu_torch.lint import failgraph, lockgraph, rnggraph, wiregraph
from d4pg_tpu_torch.lint.context import ModuleContext, build_context
from d4pg_tpu_torch.lint.findings import Finding, Suppressions
from d4pg_tpu_torch.lint.rules import RULES

# CLI mode -> (graph pass, the program families it emits)
PASSES = {
    "locks": (lockgraph, lockgraph.LOCK_RULES),
    "wire": (wiregraph, wiregraph.WIRE_RULES),
    "fail": (failgraph, failgraph.FAIL_RULES),
    "rng": (rnggraph, rnggraph.RNG_RULES),
}


@dataclass
class LintResult:
    findings: list[Finding] = field(default_factory=list)  # unsuppressed
    suppressed: list[Finding] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)  # unparseable files

    @property
    def clean(self) -> bool:
        return not self.findings and not self.errors


def iter_py_files(paths: list[str]):
    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py"):
                yield path
        else:
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in {"__pycache__", ".git", "_native"})
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def load_contexts(paths: list[str]) -> tuple[
        list[ModuleContext], dict[str, Suppressions], list[str]]:
    """Parse every file under ``paths`` once: contexts, suppression
    tables and the files that could not be read or parsed."""
    ctxs: list[ModuleContext] = []
    sups: dict[str, Suppressions] = {}
    errors: list[str] = []
    for path in iter_py_files(paths):
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
        except OSError as e:
            errors.append(f"{path}: {e}")
            continue
        try:
            ctxs.append(build_context(path, source))
        except SyntaxError as e:
            errors.append(f"{path}: syntax error: {e}")
            continue
        sups[path] = Suppressions.parse(source)
    return ctxs, sups, errors


def analyze_program(ctxs: list[ModuleContext],
                    program_ids: list[str] | None = None) -> dict:
    """Run each graph pass that owns a requested program family, once;
    ``None`` requests every family. Returns mode -> graph."""
    graphs = {}
    for mode, (module, ids) in PASSES.items():
        want = [r for r in ids if program_ids is None or r in program_ids]
        if want:
            graphs[mode] = module.analyze(ctxs, rules=want)
    return graphs


def _sift(collected: list[Finding], sup: Suppressions,
          result: LintResult) -> None:
    for f in sorted(collected, key=lambda f: (f.line, f.col, f.rule)):
        if sup.covers(f):
            f.suppressed = True
            result.suppressed.append(f)
        else:
            result.findings.append(f)


def _lint(ctxs: list[ModuleContext], sups: dict[str, Suppressions],
          rules: list[str] | None, result: LintResult) -> dict:
    active = [RULES[r] for r in rules] if rules else list(RULES.values())
    for ctx in ctxs:
        collected: list[Finding] = []
        for rule in active:
            if rule.scope == "module":
                collected.extend(rule.check(ctx))
        _sift(collected, sups[ctx.path], result)
    program_ids = [r.id for r in active if r.scope == "program"]
    graphs = analyze_program(ctxs, program_ids) if ctxs and program_ids \
        else {}
    per_file: dict[str, list[Finding]] = {}
    for graph in graphs.values():
        for f in graph.findings:
            per_file.setdefault(f.file, []).append(f)
    for path, found in sorted(per_file.items()):
        _sift(found, sups.get(path, Suppressions()), result)
    return graphs


def lint_source(source: str, path: str = "<string>",
                rules: list[str] | None = None) -> LintResult:
    """Lint one source string; the unit the fixture tests drive. The
    program families see a one-module program."""
    result = LintResult()
    try:
        ctx = build_context(path, source)
    except SyntaxError as e:
        result.errors.append(f"{path}: syntax error: {e}")
        return result
    _lint([ctx], {path: Suppressions.parse(source)}, rules, result)
    return result


def lint_tree(paths: list[str], rules: list[str] | None = None
              ) -> tuple[LintResult, dict]:
    """Lint every file under ``paths``; also return the graphs the
    program families were read from (mode -> graph)."""
    ctxs, sups, errors = load_contexts(paths)
    result = LintResult(errors=errors)
    graphs = _lint(ctxs, sups, rules, result)
    return result, graphs


def lint_paths(paths: list[str],
               rules: list[str] | None = None) -> LintResult:
    return lint_tree(paths, rules)[0]


def build_graph(mode: str, paths: list[str]):
    """One mode's review artifact over ``paths`` (``--locks``,
    ``--wire``, ``--fail`` or ``--rng``): the graph, with every family of
    that pass emitting, and the files that could not be parsed."""
    ctxs, _sups, errors = load_contexts(paths)
    return PASSES[mode][0].analyze(ctxs), errors
