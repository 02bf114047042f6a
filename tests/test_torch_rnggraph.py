"""RNG-provenance static analysis of the port (``d4pg_tpu_torch.lint.
rnggraph``, families 22-24) against its reference.

The fixture tests of the reference's ``tests/test_rnggraph.py`` drive
each family on a known-bad snippet and its known-good variant (parsed,
never executed — determinism scope is entered by giving the fixture a
``fleet/`` path or a ``chaos`` stem). ``test_parity_with_reference`` runs
both lints on every one of those sources and asserts the same
``(rule, line, col)`` findings. The package halves gate the real tree:
the rng graph over ``d4pg_tpu_torch/`` and ``chip_smoke.py`` must
discover streams and branch sites, resolve every declared stream owner
and carry zero findings, and the ``--rng`` / ``--all`` CLI artifacts
must exit 0. The graph is built once for this module; the CLI halves
print it rather than rebuild it.

Not carried: the reference's interprocedural ``prng-key-reuse`` tests
(that family reads ``jax.random`` keys) and its DrawLedger runtime tests
(``obs/``, not the lint).
"""

import ast
import json
import os
import textwrap
from pathlib import Path

import pytest

import d4pg_tpu_torch
from d4pg_tpu.lint import lint_source as reference_lint_source
from d4pg_tpu_torch.lint import __main__ as cli
from d4pg_tpu_torch.lint import lint_source
from d4pg_tpu_torch.lint.__main__ import main as lint_main

pytestmark = [pytest.mark.rnglint, pytest.mark.torchport]

PACKAGE_DIR = os.path.dirname(os.path.abspath(d4pg_tpu_torch.__file__))
REPO_ROOT = os.path.dirname(PACKAGE_DIR)
CHIP_SMOKE = os.path.join(REPO_ROOT, "chip_smoke.py")
RNG_RULES = ("rng-ambient-stream", "rng-stream-thread-escape",
             "rng-draw-count-drift")


def findings(src, rule, path="fleet/fixture.py"):
    """Fixtures default to a determinism-scoped path — families 22/24
    only patrol fleet/elastic/replay/obs/analysis code."""
    res = lint_source(textwrap.dedent(src), path)
    assert not res.errors, res.errors
    return [f for f in res.findings if f.rule == rule]


def test_numpy_module_global_draw_fires():
    out = findings("""
        import numpy as np

        def tick():
            return np.random.randn(4)
        """, "rng-ambient-stream")
    assert len(out) == 1
    assert "hidden module-level global stream" in out[0].message


def test_stdlib_random_draw_fires():
    out = findings("""
        import random

        def jitter():
            return random.random() * 0.1
        """, "rng-ambient-stream")
    assert len(out) == 1
    assert "process-global Random" in out[0].message


def test_unseeded_default_rng_fires():
    out = findings("""
        import numpy as np

        def make():
            rng = np.random.default_rng()
            return rng.random()
        """, "rng-ambient-stream")
    assert len(out) == 1
    assert "unseeded" in out[0].message


def test_wallclock_seed_fires():
    out = findings("""
        import time
        import numpy as np

        def make():
            rng = np.random.default_rng(int(time.time()))
            return rng.random()
        """, "rng-ambient-stream")
    assert len(out) == 1
    assert "wall-clock" in out[0].message


def test_branched_component_stream_clean():
    out = findings("""
        import numpy as np

        def make(seed):
            rng = np.random.default_rng(
                np.random.SeedSequence(seed, spawn_key=(1,)))
            return rng.random()
        """, "rng-ambient-stream")
    assert out == []


def test_ambient_outside_determinism_scope_clean():
    """The same ambient draw in a non-scoped module (no fleet/elastic/
    replay/obs/analysis directory, no chaos/traffic/sampler stem) is
    out of the family's jurisdiction."""
    out = findings("""
        import numpy as np

        def tick():
            return np.random.randn(4)
        """, "rng-ambient-stream", path="util/fixture.py")
    assert out == []


_SHARED_STREAM = """
    import threading
    import numpy as np

    class Pump:
        def __init__(self, seed):
            self._rng = np.random.default_rng({ctor})

        def start(self):
            threading.Thread(target=self._send).start()
            threading.Thread(target=self._recv).start()

        def _send(self):
            return self._rng.random()

        def _recv(self):
            return self._rng.random()
    """


def _owned_stream(owner: str, with_owner: bool = False) -> str:
    """The shared stream, its constructor declaring ``owner``; with
    ``with_owner``, a seeded ``Owner._rng`` component stream too."""
    src = _SHARED_STREAM.format(ctor="seed")
    if with_owner:
        src += """
    class Owner:
        def __init__(self, seed):
            self._rng = np.random.default_rng(
                np.random.SeedSequence(seed, spawn_key=(3,)))
    """
    return src.replace(
        "self._rng = np.random.default_rng(seed)",
        "self._rng = np.random.default_rng(seed)"
        f"  # jaxlint: stream-owner={owner}")


def test_shared_stream_across_threads_fires():
    out = findings(_SHARED_STREAM.format(ctor="seed"),
                   "rng-stream-thread-escape")
    assert len(out) == 1
    assert "2 distinct thread-spawn targets" in out[0].message
    assert "Pump._send" in out[0].message and "Pump._recv" in out[0].message


def test_branched_stream_across_threads_clean():
    out = findings(
        _SHARED_STREAM.format(
            ctor="np.random.SeedSequence(seed, spawn_key=(7,))"),
        "rng-stream-thread-escape")
    assert out == []


def test_stream_owner_annotation_satisfies():
    """A caller-owned stream may declare its owner; the declaration is
    audited — the named stream must be a discovered seeded component
    stream."""
    out = findings(_owned_stream("Owner._rng", with_owner=True),
                   "rng-stream-thread-escape")
    assert out == []


def test_stream_owner_unresolved_fires():
    out = findings(_owned_stream("Ghost._rng"), "rng-stream-thread-escape")
    assert len(out) == 1
    assert "does not resolve" in out[0].message


def test_conditional_draw_then_reuse_fires():
    """The backpressure desync shape: one branch draws, both paths then share
    the stream — the second draw's offset is path-dependent."""
    out = findings("""
        import numpy as np

        def step(flag, seed):
            rng = np.random.default_rng(seed)
            if flag:
                a = rng.random()
            return rng.random()
        """, "rng-draw-count-drift")
    assert len(out) == 1
    assert "path-dependent" in out[0].message


def test_skip_before_rng_use_idiom_clean():
    """Paths that exit the loop body before the FIRST draw are the
    documented skip idiom: every drawing iteration consumes the same
    fixed count, so the event index stays aligned."""
    out = findings("""
        import numpy as np

        def consume(items, seed):
            rng = np.random.default_rng(seed)
            out = []
            for it in items:
                if it is None:
                    continue
                out.append(rng.random())
            return out
        """, "rng-draw-count-drift")
    assert out == []


def test_per_iteration_drift_fires():
    out = findings("""
        import numpy as np

        def consume(items, seed):
            rng = np.random.default_rng(seed)
            out = []
            for it in items:
                u = rng.random()
                if it > 0:
                    u += rng.random()
                out.append(u)
            return out
        """, "rng-draw-count-drift")
    assert len(out) == 1
    assert "per loop iteration" in out[0].message


def test_fixed_draws_per_event_clean():
    """The sanctioned chaos shape: a fixed draw count per event, fate
    decided from the drawn uniforms afterwards."""
    out = findings("""
        import numpy as np

        def consume(items, seed):
            rng = np.random.default_rng(seed)
            out = []
            for it in items:
                u_a, u_b = rng.random(2)
                if u_a < 0.5:
                    out.append(u_b)
            return out
        """, "rng-draw-count-drift")
    assert out == []


def test_persistent_stream_exit_total_drift_fires():
    """An attr stream outlives the frame: two call paths leaving with
    different nonzero totals desync every later consumer."""
    out = findings("""
        import numpy as np

        class Chaos:
            def __init__(self, seed):
                self._rng = np.random.default_rng(seed)

            def step(self, flag):
                u = self._rng.random()
                if flag:
                    u += self._rng.random()
                return u
        """, "rng-draw-count-drift")
    assert len(out) == 1
    assert "path-dependent total" in out[0].message


def test_rng_cli_mode_fires_on_fixture(tmp_path, capsys):
    """`--rng` exits 1 iff a family fires, 0 on the clean variant. The
    fixture filename carries a scoped stem (chaos) — scope is a path
    property, not a flag."""
    bad = tmp_path / "chaos_bad.py"
    bad.write_text(textwrap.dedent("""
        import numpy as np

        def tick():
            return np.random.randn(4)
        """))
    assert lint_main(["--rng", str(bad)]) == 1
    out = capsys.readouterr().out
    assert "rng-ambient-stream" in out

    good = tmp_path / "chaos_good.py"
    good.write_text(textwrap.dedent("""
        import numpy as np

        def make(seed):
            rng = np.random.default_rng(
                np.random.SeedSequence(seed, spawn_key=(1,)))
            return rng.random()
        """))
    assert lint_main(["--rng", str(good)]) == 0
    out = capsys.readouterr().out
    assert "findings: none" in out
    assert "[default_rng/branched]" in out


def test_json_rng_mode(tmp_path, capsys):
    src = tmp_path / "chaos_mod.py"
    src.write_text(textwrap.dedent("""
        import numpy as np

        def make(seed):
            rng = np.random.default_rng(
                np.random.SeedSequence(seed, spawn_key=(1,)))
            return rng.random()
        """))
    assert lint_main(["--rng", "--json", str(src)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["schema"] == 1 and doc["mode"] == "rng"
    assert doc["findings"] == [] and doc["errors"] == []
    for key in ("functions", "modules", "scoped", "streams", "branches",
                "handlers"):
        assert key in doc, key
    assert len(doc["streams"]) == 1
    row = doc["streams"][0]
    assert set(row) == {"site", "owner", "ctor", "seed", "draws", "threads"}
    assert row["seed"] == "branched"
    assert len(doc["branches"]) == 1


def test_json_all_mode_carries_rng_section(tmp_path, capsys):
    src = tmp_path / "chaos_mod.py"
    src.write_text(textwrap.dedent("""
        import numpy as np

        def make(seed):
            rng = np.random.default_rng(
                np.random.SeedSequence(seed, spawn_key=(1,)))
            return rng.random()
        """))
    assert lint_main(["--all", "--json", str(src)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert "rng" in doc
    assert doc["rng"]["findings"] == [] and doc["rng"]["errors"] == []
    assert doc["rng"]["streams"]


# ------------------------------------ package gates -----------------------

@pytest.fixture(scope="module")
def package_graph():
    from d4pg_tpu_torch.lint.engine import build_graph

    return build_graph("rng", [PACKAGE_DIR, CHIP_SMOKE])


@pytest.mark.lint
def test_rng_graph_clean_over_package(package_graph):
    """Tier-1 gate for the determinism surface: the whole-program rng
    graph over ``d4pg_tpu_torch/`` + ``chip_smoke.py`` must discover the
    component streams and their SeedSequence branch sites, resolve every
    declared stream owner, and carry zero findings."""
    from d4pg_tpu_torch.lint.rnggraph import format_rnggraph

    graph, errors = package_graph
    assert not errors, errors
    assert graph.findings == [], format_rnggraph(graph)
    assert graph.streams, "no RNG streams discovered — walker rot?"
    assert graph.branches, "no SeedSequence branch sites — walker rot?"
    assert graph.scoped > 0
    assert graph.handlers == {"ReplayBuffer._rng": "ok"}, graph.handlers
    # the ledger-wrapped chaos/traffic streams must stay discoverable
    # THROUGH the wrap (the lint/runtime twins see the same streams)
    wrapped = [s for s in graph.streams if "+ledger:" in s[3]]
    assert any("schedule." in s[3] for s in wrapped), graph.streams


@pytest.mark.lint
def test_cli_rng_mode_clean(package_graph, monkeypatch, capsys):
    """``python -m d4pg_tpu_torch.lint --rng`` is the review artifact for
    determinism PRs; over the repo it must exit 0 and print the stream
    table, the branch sites, and no findings (the CLI is handed the
    module's graph instead of building it again)."""
    seen = []

    def built(mode, paths):
        seen.append((mode, paths))
        return package_graph

    monkeypatch.setattr(cli, "build_graph", built)
    assert lint_main(["--rng", PACKAGE_DIR, CHIP_SMOKE]) == 0
    out = capsys.readouterr().out
    assert seen == [("rng", [PACKAGE_DIR, CHIP_SMOKE])]
    assert "rnggraph:" in out
    assert "streams (ctor site -> owner [ctor/seed] draws threads):" in out
    assert "branch sites (SeedSequence / spawn):" in out
    assert "stream-owner=ReplayBuffer._rng [ok]" in out
    assert "findings: none" in out


# ------------------------------------------- parity with the reference ----

def _fixture_sources() -> list:
    """(test name, source, path) for every fixture of this file: the
    source argument of each ``findings(...)`` call (evaluated, so the
    formatted shared-stream fixtures count) with its path, and each
    ``textwrap.dedent`` literal of the CLI tests under their ``chaos``
    stem."""
    tree = ast.parse(Path(__file__).read_text())
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) \
                or not fn.name.startswith("test_"):
            continue
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            callee = ast.unparse(node.func)
            if callee == "findings":
                path = next((ast.literal_eval(k.value)
                             for k in node.keywords if k.arg == "path"),
                            "fleet/fixture.py")
                src = eval(ast.unparse(node.args[0]), globals())
                out.append((fn.name, src, path))
            elif callee == "textwrap.dedent" and isinstance(
                    node.args[0], ast.Constant):
                out.append((fn.name, node.args[0].value, "chaos_fixture.py"))
    return out


FIXTURES = _fixture_sources()


def test_parity_covers_every_fixture():
    names = {name for name, _src, _path in FIXTURES}
    assert len(FIXTURES) == 19 and len(names) == 18, (len(FIXTURES),
                                                      len(names))


@pytest.mark.parametrize("name,src,path", FIXTURES,
                         ids=[f"{n}-{i}" for i, (n, _s, _p) in
                              enumerate(FIXTURES)])
def test_parity_with_reference(name, src, path):
    src = textwrap.dedent(src)

    def sites(res):
        return sorted((f.rule, f.line, f.col) for f in res.findings
                      if f.rule in RNG_RULES)

    port = lint_source(src, path, rules=list(RNG_RULES))
    ref = reference_lint_source(src, path, rules=list(RNG_RULES))
    assert port.errors == ref.errors
    assert sites(port) == sites(ref)
