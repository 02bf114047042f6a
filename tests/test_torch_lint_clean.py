"""Tier-1 lint gate of the port: ``d4pg_tpu_torch`` and ``chip_smoke.py``
must lint clean under the port's own lint (``d4pg_tpu_torch.lint``).

Counterpart of the reference's ``tests/test_lint_clean.py``. Every hazard
the lint can see is fixed, or carries an audited annotation whose
comment explains it. The package's analysis is built once for this
module (``package``), and one ``python -m d4pg_tpu_torch.lint --all
--json`` subprocess over the default paths (``cli_doc``) feeds every
JSON check; the per-mode text artifacts are printed from the same
graphs. ``chip_smoke.py`` is linted on its own, as the reference lints
its root script ``bench.py``.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

import d4pg_tpu_torch
from d4pg_tpu_torch.lint import __main__ as cli
from d4pg_tpu_torch.lint import lint_source
from d4pg_tpu_torch.lint.engine import lint_tree

pytestmark = [pytest.mark.lint, pytest.mark.torchport]

PACKAGE_DIR = os.path.dirname(os.path.abspath(d4pg_tpu_torch.__file__))
REPO_ROOT = os.path.dirname(PACKAGE_DIR)
CHIP_SMOKE = os.path.join(REPO_ROOT, "chip_smoke.py")


@pytest.fixture(scope="module")
def package():
    """(LintResult, mode -> graph) over the package, every family."""
    return lint_tree([PACKAGE_DIR])


@pytest.fixture(scope="module")
def smoke():
    return lint_tree([CHIP_SMOKE])


@pytest.fixture(scope="module")
def cli_doc():
    proc = subprocess.run(
        [sys.executable, "-m", "d4pg_tpu_torch.lint", "--all", "--json"],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO_ROOT})
    return proc.returncode, proc.stdout, proc.stderr


def _msgs(result) -> str:
    return "\n".join([f.format() for f in result.findings] + result.errors)


def test_package_lints_clean(package):
    result, _graphs = package
    assert result.clean, (
        "jaxlint found unsuppressed hazards:\n" + _msgs(result))


def test_chip_smoke_lints_clean(smoke):
    """The script that drives the port on the card is held to the same
    bar as the package."""
    result, _graphs = smoke
    assert result.clean, (
        "jaxlint found unsuppressed hazards:\n" + _msgs(result))


def test_chip_smoke_lane_exception_reaches_its_phase():
    """A worker thread of a ``chip_smoke.py`` phase used to be a bare
    ``threading.Thread(target=lane)``: its exception went to
    ``threading.excepthook`` and the phase went on. The lint flags that
    shape; the script's ``_Threads`` keeps each thread's exception and
    re-raises the first after the joins, so the phase fails."""
    bare = findings_of("""
        import threading

        def phase():
            def lane(i):
                raise ValueError(i)

            threads = [threading.Thread(target=lane, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        """)
    assert [f.rule for f in bare] == ["thread-crash-containment"]
    assert "die silently" in bare[0].message

    spec = importlib.util.spec_from_file_location("chip_smoke", CHIP_SMOKE)
    smoke_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke_mod)
    import threading

    barrier = threading.Barrier(3)
    lanes = smoke_mod._Threads(on_error=barrier.abort)

    def lane(i):
        if i == 0:
            raise ValueError("lane 0 died")
        barrier.wait()  # released by the abort, not left waiting

    for i in range(3):
        lanes.start(lane, i)
    with pytest.raises(ValueError, match="lane 0 died"):
        lanes.join(timeout=30.0)
    assert not any(t.is_alive() for t in lanes.threads)
    assert isinstance(lanes.errors[0], ValueError)
    assert all(isinstance(e, threading.BrokenBarrierError)
               for e in lanes.errors[1:])
    quiet = smoke_mod._Threads()
    quiet.start(lambda: None)
    quiet.join()  # nothing raised, nothing kept
    assert quiet.errors == []


def findings_of(src):
    res = lint_source(textwrap.dedent(src), "fixture.py")
    assert not res.errors, res.errors
    return res.findings


def test_suppression_audit(package, smoke):
    """Audit every ``# jaxlint:`` annotation of the package and
    ``chip_smoke.py``: a ``disable`` names only registered rules, a
    ``guarded-by`` a lock the lock graph knows, a ``contained-by`` a
    handler the exception-flow graph resolved and verified contained
    and counted, a ``stream-owner`` a stream the rng graph discovered
    and verified seeded or branched; and each carries a justification
    comment beside it."""
    from d4pg_tpu_torch.lint.lockgraph import _DEFAULT_TIERS
    from d4pg_tpu_torch.lint.rules import RULES

    directive = re.compile(r"#\s*jaxlint:\s*disable(?:-file)?=([\w,\- ]+)")
    guarded = re.compile(r"#\s*jaxlint:\s*guarded-by=([\w,\- ]+)")
    contained = re.compile(r"#\s*jaxlint:\s*contained-by=([\w\.\-,]+)")
    stream_owner = re.compile(r"#\s*jaxlint:\s*stream-owner=([\w\.\-,]+)")
    annotations = (directive, guarded, contained, stream_owner)
    _result, graphs = package
    known_locks = set(graphs["locks"].nodes) | set(_DEFAULT_TIERS)
    handlers = {**graphs["fail"].handlers, **smoke[1]["fail"].handlers}
    owners = {**graphs["rng"].handlers, **smoke[1]["rng"].handlers}
    files = [CHIP_SMOKE]
    for dirpath, _dirs, names in os.walk(PACKAGE_DIR):
        # the lint package's own docs name the directives in strings
        if os.sep + "lint" not in dirpath[len(PACKAGE_DIR):]:
            files.extend(os.path.join(dirpath, n) for n in names
                         if n.endswith(".py"))
    audited, kinds, problems = 0, set(), []
    for path in files:
        with open(path) as f:
            lines = f.readlines()
        for i, line in enumerate(lines):
            hits = [rx.search(line) for rx in annotations]
            if not any(hits):
                continue
            audited += 1
            m, g, c, s = hits
            where = f"{os.path.relpath(path, REPO_ROOT)}:{i + 1}"
            if m is not None:
                kinds.add("disable")
                for rule in m.group(1).replace(" ", "").split(","):
                    if rule not in RULES:
                        problems.append(f"{where}: unknown rule {rule!r}")
            if g is not None:
                kinds.add("guarded-by")
                for lock in g.group(1).replace(" ", "").split(","):
                    if lock not in known_locks:
                        problems.append(f"{where}: guarded-by names "
                                        f"unknown lock {lock!r}")
            if c is not None:
                kinds.add("contained-by")
                for spec in c.group(1).split(","):
                    if handlers.get(spec) != "ok":
                        problems.append(f"{where}: contained-by {spec!r} "
                                        f"has status {handlers.get(spec)!r}")
            if s is not None:
                kinds.add("stream-owner")
                for spec in s.group(1).split(","):
                    if owners.get(spec) != "ok":
                        problems.append(f"{where}: stream-owner {spec!r} "
                                        f"has status {owners.get(spec)!r}")
            # the justification: a comment near the annotation that is not
            # itself a directive, or the def's docstring below it
            lo, hi = max(0, i - 6), min(len(lines), i + 2)
            near = lines[lo:hi]
            justified = any(
                "#" in nl and not any(rx.search(nl) for rx in annotations)
                for nl in near) or '"""' in "".join(near)
            if m is not None:
                # a disable also gives its reason on its own line
                justified = justified and bool(
                    line[m.end():].strip(" -—:\n"))
            if not justified:
                problems.append(f"{where}: annotation without an adjacent "
                                "justification comment")
    # the reference's 12 framework-neutral annotations, put back
    assert audited == 12, audited
    assert kinds == {"guarded-by", "contained-by", "stream-owner"}, kinds
    assert not problems, "\n".join(problems)


def test_lock_graph_clean_over_package(package):
    """The whole-program lock graph over the package carries the declared
    locks with their tiers, no cycle, and no ascent out of a leaf
    tier."""
    from d4pg_tpu_torch.core.locking import HIERARCHY
    from d4pg_tpu_torch.lint.lockgraph import _DEFAULT_TIERS, format_graph

    graph = package[1]["locks"]
    assert graph.cycles == [], format_graph(graph)
    for lock, tier in (("_lock", "service"), ("_buffer_lock", "buffer"),
                       ("_commit_cond", "commit"), ("cond", "shard"),
                       ("_ring_locks", "ring"), ("_relay_lock", "wrelay"),
                       ("_frame_lock", "wserve"), ("_store_lock", "wstore"),
                       ("_replica_lock", "replica"), ("_agg_cond", "agg"),
                       ("_pserve_cond", "pserve"), ("_elastic_cond", "elastic"),
                       ("_sampler_lock", "sampler")):
        assert graph.nodes.get(lock) == tier, (lock, sorted(graph.nodes))
    tiers = dict(_DEFAULT_TIERS)
    tiers.update({k: v for k, v in graph.nodes.items() if v})
    for (held, acquired) in graph.edges:
        th = HIERARCHY.get(tiers.get(held, ""))
        tb = HIERARCHY.get(tiers.get(acquired, ""))
        if th is not None and tb is not None and held != acquired:
            assert not (th <= HIERARCHY["shard"] and tb >= th), (
                f"leaf ascent {held} -> {acquired}: "
                + str(graph.edges[(held, acquired)]))


def test_wire_graph_clean_over_package(package):
    """The wire graph over the package discovers every magic of the
    port's registry with a pack and an unpack witness, reproduces its
    flag-bit map, and carries no finding."""
    from d4pg_tpu_torch.core import wire
    from d4pg_tpu_torch.lint.wiregraph import format_registry

    graph = package[1]["wire"]
    assert graph.findings == [], format_registry(graph)
    assert set(graph.magics) == {s.magic for s in wire.REGISTRY.values()}
    for magic, e in graph.magics.items():
        assert e["packs"], f"{magic!r}: no pack witness discovered"
        assert e["unpacks"], f"{magic!r}: no unpack witness discovered"
        assert e["plane"] is not None
    for plane, bits in wire.PLANE_FLAG_BITS.items():
        if bits:
            assert graph.flags.get(plane) == dict(bits), (plane, graph.flags)
        else:
            assert not graph.flags.get(plane), (plane, graph.flags)


@pytest.mark.failflow
def test_fail_graph_clean_over_package(package):
    """Every thread spawn of the package is contained (or covered by an
    audited declaration), every trace begin settled or escrowed, every
    admission counter balanced."""
    from d4pg_tpu_torch.lint.failgraph import format_failgraph

    graph = package[1]["fail"]
    assert graph.findings == [], format_failgraph(graph)
    assert graph.threads, "no thread spawns discovered — walker rot?"
    for site, target, status in graph.threads:
        assert status in ("contained", "no-raise", "contained-by"), (
            site, target, status)
    for site, root, status in graph.spans:
        assert status in ("settled", "escrow"), (site, root, status)
    for site, counter, status in graph.ledger:
        assert status == "balanced", (site, counter, status)
    assert graph.handlers == {"ThrottledSender.run": "ok"}, graph.handlers
    discovered = " ".join(t for _s, t, _st in graph.threads)
    for frame in ("TransitionReceiver._accept", "AggregatorServer._serve",
                  "WeightServer._accept", "PolicyInferenceServer._batcher",
                  "ReplayService._commit_loop", "Autoscaler._run"):
        assert frame in discovered, discovered


def test_tier_mirror_matches_hierarchy():
    """``lockgraph._TIER_VALUES`` mirrors the port's lock hierarchy
    instead of importing it; this pin keeps the mirror true."""
    from d4pg_tpu_torch.core.locking import HIERARCHY
    from d4pg_tpu_torch.lint.lockgraph import _DEFAULT_TIERS, _TIER_VALUES

    assert _TIER_VALUES == HIERARCHY
    assert set(_DEFAULT_TIERS.values()) <= set(HIERARCHY)


def test_wire_mirror_matches_declared_registry():
    """``wiregraph._DECLARED`` mirrors the port's ``core.wire.REGISTRY``;
    any drift (a row, a format, a flag, a crc discipline) fails here
    with the rows named."""
    from d4pg_tpu_torch.core import wire
    from d4pg_tpu_torch.lint.wiregraph import _DECLARED

    declared = {
        name: (spec.plane, spec.magic, spec.header, spec.crc,
               tuple(sorted(spec.flags)),
               tuple(fmt for _ext_name, fmt in spec.extensions))
        for name, spec in wire.REGISTRY.items()}
    mirrored = {
        row[0]: (row[1], row[2], row[3], row[4],
                 tuple(sorted(row[5])), tuple(row[6]))
        for row in _DECLARED}
    assert mirrored == declared
    assert len(mirrored) == 12


def test_cli_all_json_over_default_paths(cli_doc, package):
    """``python -m d4pg_tpu_torch.lint --all --json`` with no paths reads
    the port's package: it exits 0 with ONE schema-1 document carrying
    the findings and the four graph sections (no ``mesh``), and that
    document is the library's for the same tree."""
    rc, out, err = cli_doc
    assert rc == 0, out[-4000:] + err[-4000:]
    doc = json.loads(out)
    assert doc["schema"] == 1 and doc["mode"] == "all", sorted(doc)
    assert doc["findings"] == [] and doc["errors"] == []
    assert doc["suppressed"] == 0
    sections = {
        "locks": {"functions", "nodes", "edges", "cycles"},
        "wire": {"functions", "modules", "magics", "flags"},
        "fail": {"functions", "modules", "threads", "spans", "ledger",
                 "handlers"},
        "rng": {"functions", "modules", "scoped", "streams", "branches",
                "handlers"},
    }
    assert set(doc) == {"schema", "mode", "findings", "errors",
                        "suppressed", *sections}
    for section, keys in sections.items():
        sub = doc[section]
        assert sub["findings"] == [] and sub["errors"] == [], section
        assert set(sub) == keys | {"findings", "errors"}, (section,
                                                           sorted(sub))
    assert doc["locks"]["cycles"] == []
    assert doc == json.loads(json.dumps(cli.all_document(*package)))


def test_json_modes_hold_their_schema(package, cli_doc, monkeypatch, capsys):
    """Each single-mode ``--json`` document is its ``--all`` section plus
    ``schema`` and ``mode``, and each mode's text artifact prints, over
    the package's graphs (handed to the CLI, not rebuilt)."""
    _result, graphs = package
    monkeypatch.setattr(cli, "build_graph",
                        lambda mode, paths: (graphs[mode], []))
    all_doc = json.loads(cli_doc[1])
    for mode in ("locks", "wire", "fail", "rng"):
        flag = "--rng" if mode == "rng" else f"--{mode}"
        assert cli.main([flag, "--json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc.pop("schema") == 1 and doc.pop("mode") == mode
        assert doc == all_doc[mode], mode
    text = {}
    for flag in ("--locks", "--wire", "--fail", "--rng"):
        assert cli.main([flag]) == 0
        text[flag] = capsys.readouterr().out
    assert "cycles: none" in text["--locks"]
    assert "_commit_cond" in text["--locks"]
    assert "findings: none" in text["--wire"]
    for magic in ("0xD4AB", "0xD4E2", "0xD4E3", "0xD4F6", "0xD4F7",
                  "0xD4F8", "0xD4FA", "0xD4FC", "D4RS"):
        assert magic in text["--wire"], magic
    assert "flag bits:" in text["--wire"]
    assert "thread roles" in text["--fail"]
    assert "contained-by=ThrottledSender.run [ok]" in text["--fail"]
    assert "findings: none" in text["--rng"]
