"""CLI: ``python -m d4pg_tpu_torch.lint [paths] [--rules a,b] [--list-rules]``.

Counterpart of ``python -m d4pg_tpu.lint``, with the same flags, exit
codes and ``--json`` schema, less the reference's ``--mesh`` mode (its
sharding/collective families read JAX and are not carried).

Exit code 0 when every finding is suppressed (or none exist), 1 otherwise.
With no paths, lints the ``d4pg_tpu_torch`` package itself.

``--locks`` prints the discovered whole-program lock graph (nodes, edges
with witness sites, cycles) instead of findings — the review artifact
for concurrency-touching PRs; exit 1 iff the graph has a cycle.

``--wire`` prints the discovered wire-protocol registry (magics, owning
planes, pack/unpack witness sites, flag-bit map) — the review artifact
for protocol-touching PRs; exit 1 iff any wire family fires.

``--fail`` prints the thread-role/containment/span-lifecycle graph from
the exception-flow pass (families 16-18) — the review artifact for
thread- or obs-touching PRs; exit 1 iff any fail family fires.

``--rng`` prints the RNG stream table (owner, constructor, seed
provenance, draw sites, thread reachability) and SeedSequence branch
sites from the determinism pass (families 22-24) — the review artifact
for chaos/traffic/sampler-touching PRs; exit 1 iff any rng family
fires.

``--all`` runs the syntactic family AND all four graph modes and emits
ONE merged document — the single entrypoint CI gates on.

``--json`` switches any mode to a machine-readable document on stdout:
``{"schema": 1, "mode": ..., "findings": [...], ...}`` — the contract
tests/test_torch_lint_clean.py gates so CI tooling never scrapes the
human-oriented text.

Everything here is host work over source files: it needs no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from d4pg_tpu_torch.lint.engine import build_graph, lint_paths, lint_tree
from d4pg_tpu_torch.lint.failgraph import format_failgraph
from d4pg_tpu_torch.lint.lockgraph import format_graph
from d4pg_tpu_torch.lint.rnggraph import format_rnggraph
from d4pg_tpu_torch.lint.rules import RULES
from d4pg_tpu_torch.lint.wiregraph import format_registry

JSON_SCHEMA_VERSION = 1


def _magic_key(m) -> str:
    # magics are u16 ints except the ASCII resync sentinel (bytes)
    return f"0x{m:04X}" if isinstance(m, int) else m.decode("ascii")


def _finding_doc(f) -> dict:
    return {"file": f.file, "line": f.line, "col": f.col, "rule": f.rule,
            "message": f.message, "suppressed": f.suppressed}


def _doc(mode: str, findings, errors, **extra) -> dict:
    doc = {"schema": JSON_SCHEMA_VERSION, "mode": mode,
           "findings": [_finding_doc(f) for f in findings],
           "errors": list(errors)}
    doc.update(extra)
    return doc


# Per-mode artifact keys, shared by the single-mode ``--json`` documents
# and the merged ``--all`` document (one encoder per artifact — the two
# paths cannot drift).

def _locks_extra(graph) -> dict:
    return {
        "functions": graph.functions,
        "nodes": {n: t for n, t in sorted(graph.nodes.items())},
        "edges": [{"held": a, "acquired": b, "witnesses": w}
                  for (a, b), w in sorted(graph.edges.items())],
        "cycles": graph.cycles,
    }


def _wire_extra(graph) -> dict:
    return {
        "functions": graph.functions, "modules": graph.modules,
        "magics": {_magic_key(m): info
                   for m, info in sorted(graph.magics.items(),
                                         key=lambda kv: _magic_key(kv[0]))},
        "flags": {plane: {str(bit): meaning
                          for bit, meaning in sorted(bits.items())}
                  for plane, bits in sorted(graph.flags.items())},
    }


def _fail_extra(graph) -> dict:
    return {
        "functions": graph.functions, "modules": graph.modules,
        "threads": [{"site": s, "target": t, "status": st}
                    for s, t, st in sorted(graph.threads)],
        "spans": [{"site": s, "root": r, "status": st}
                  for s, r, st in sorted(graph.spans)],
        "ledger": [{"site": s, "counter": c, "status": st}
                   for s, c, st in sorted(graph.ledger)],
        "handlers": dict(sorted(graph.handlers.items())),
    }


def _rng_extra(graph) -> dict:
    return {
        "functions": graph.functions, "modules": graph.modules,
        "scoped": graph.scoped,
        "streams": [{"site": s, "owner": o, "ctor": c, "seed": sd,
                     "draws": d, "threads": t}
                    for s, o, c, sd, d, t in sorted(graph.streams)],
        "branches": [{"site": s, "src": x}
                     for s, x in sorted(graph.branches)],
        "handlers": dict(sorted(graph.handlers.items())),
    }


# mode -> (artifact encoder, text formatter); the order is the order the
# text of ``--all`` prints them in
MODES = {
    "locks": (_locks_extra, format_graph),
    "wire": (_wire_extra, format_registry),
    "fail": (_fail_extra, format_failgraph),
    "rng": (_rng_extra, format_rnggraph),
}


def _dirty(mode: str, graph) -> bool:
    """A mode's exit criterion: a cycle for ``--locks``, any finding of
    the pass's families for the others."""
    return bool(graph.cycles) if mode == "locks" else bool(graph.findings)


def all_document(result, graphs) -> dict:
    """The merged ``--all --json`` document from one lint run's result
    and the graphs its program families were read from."""
    sections = {
        mode: {"findings": [_finding_doc(f) for f in graphs[mode].findings],
               "errors": list(result.errors),
               **MODES[mode][0](graphs[mode])}
        for mode in MODES}
    return _doc("all", result.findings, result.errors,
                suppressed=len(result.suppressed), **sections)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m d4pg_tpu_torch.lint",
        description="static analysis for the d4pg_tpu_torch stack")
    parser.add_argument("paths", nargs="*",
                        help="files or directories (default: the "
                             "d4pg_tpu_torch package)")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule ids to run (default all)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    parser.add_argument("--show-suppressed", action="store_true",
                        help="also print suppressed findings")
    parser.add_argument("--locks", action="store_true",
                        help="print the whole-program lock graph (nodes, "
                             "edges, cycles) instead of findings; exit 1 "
                             "iff a cycle exists")
    parser.add_argument("--wire", action="store_true",
                        help="print the discovered wire-protocol registry "
                             "(magics, pack/unpack witnesses, flag bits) "
                             "instead of findings; exit 1 iff any wire "
                             "family fires")
    parser.add_argument("--fail", action="store_true",
                        help="print the thread-role/containment/"
                             "span-lifecycle graph (families 16-18) "
                             "instead of findings; exit 1 iff any fail "
                             "family fires")
    parser.add_argument("--rng", action="store_true", dest="rng_mode",
                        help="print the RNG stream/provenance table "
                             "(owners, seed provenance, draw sites, "
                             "thread reachability; families 22-24) "
                             "instead of findings; exit 1 iff any rng "
                             "family fires")
    parser.add_argument("--all", action="store_true", dest="all_modes",
                        help="run the syntactic family AND all four "
                             "graph modes; emit ONE merged document "
                             "(--json) or every artifact in sequence")
    parser.add_argument("--json", action="store_true",
                        help="emit a machine-readable document instead of "
                             "the human-oriented text (all modes)")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in RULES.values():
            print(f"{rule.id:22s} {rule.summary}")
        return 0

    paths = args.paths or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]

    chosen = {"locks": args.locks, "wire": args.wire, "fail": args.fail,
              "rng": args.rng_mode}
    for mode, on in chosen.items():
        if not on:
            continue
        encode, fmt = MODES[mode]
        graph, errors = build_graph(mode, paths)
        if args.json:
            print(json.dumps(_doc(mode, graph.findings, errors,
                                  **encode(graph)), indent=2))
        else:
            print(fmt(graph))
            for e in errors:
                print(e, file=sys.stderr)
        return 1 if _dirty(mode, graph) else 0

    if args.all_modes:
        # lint_tree runs every program family once, so its findings list
        # IS the merged findings list; the per-mode sections carry the
        # review artifacts of the same graphs (and re-state each mode's
        # own findings)
        result, graphs = lint_tree(paths)
        dirty = (not result.clean) or bool(graphs["locks"].cycles)
        if args.json:
            print(json.dumps(all_document(result, graphs), indent=2))
            return 1 if dirty else 0
        for mode, (_encode, fmt) in MODES.items():
            print(fmt(graphs[mode]))
            print()
        for f in result.findings:
            print(f.format())
        for e in result.errors:
            print(e, file=sys.stderr)
        n, s = len(result.findings), len(result.suppressed)
        print(f"jaxlint: {n} finding(s), {s} suppressed", file=sys.stderr)
        return 1 if dirty else 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in RULES]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)}", file=sys.stderr)
            return 2

    result = lint_paths(paths, rules=rules)

    if args.json:
        shown = list(result.findings)
        if args.show_suppressed:
            shown += result.suppressed
        print(json.dumps(_doc(
            "findings", shown, result.errors,
            suppressed=len(result.suppressed)), indent=2))
        return 0 if result.clean else 1

    for f in result.findings:
        print(f.format())
    if args.show_suppressed:
        for f in result.suppressed:
            print(f.format())
    for e in result.errors:
        print(e, file=sys.stderr)
    n, s = len(result.findings), len(result.suppressed)
    print(f"jaxlint: {n} finding(s), {s} suppressed", file=sys.stderr)
    return 0 if result.clean else 1


if __name__ == "__main__":
    raise SystemExit(main())
