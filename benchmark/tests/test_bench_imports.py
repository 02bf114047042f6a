"""What a benchmark run loads: never JAX, its libraries or the JAX
package, compared by whole top-level names (``d4pg_tpu_torch`` begins
with ``d4pg_tpu`` and is the program); and the reference loads nothing
of the program either."""

from __future__ import annotations

import ast
import subprocess
import sys

from bench_tiny import BENCH
from harness import learn

BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "d4pg_tpu"}


def test_banned_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "d4pg_tpu_torch_fake_probe", sys)
    assert "d4pg_tpu" not in learn.banned_modules()
    monkeypatch.setitem(sys.modules, "d4pg_tpu.fake_probe", sys)
    assert "d4pg_tpu" in learn.banned_modules()


RUN = """
import sys, time
sys.path[:0] = [{root!r}, {bench!r}, {tests!r}]
import torch
torch.set_num_threads(1)
sys.argv = ["run.py"]
import importlib.util
spec = importlib.util.spec_from_file_location("bench_run", {run!r})
mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)
from bench_tiny import tiny
from harness import learn, spec as hs
import json
for name in json.load(open({bjson!r}))["workloads"]:
    cell = tiny(name["name"])
    if int(cell.traffic.get("ranks", 1)) > 1:
        continue
    out = hs.plugin("runners", cell.traffic["runner"]).run(
        cell, 5, 0.0, True, time.time(), device=torch.device("cpu"))
    for m in cell.end_to_end + cell.per_layer:
        hs.plugin("metrics", m["name"])
    hs.plugin("flops", cell.config["family"])
print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_a_run_loads_no_jax():
    code = RUN.format(root=str(BENCH.parent), bench=str(BENCH),
                      tests=str(BENCH / "tests"),
                      run=str(BENCH / "run.py"),
                      bjson=str(BENCH.parent / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("LOADED")][-1]
    loaded = set(eval(line[len("LOADED "):]))
    assert "d4pg_tpu_torch" in loaded
    assert not loaded & BANNED, loaded & BANNED


def test_reference_imports_nothing_of_the_program():
    banned = BANNED | {"d4pg_tpu_torch", "harness"}
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in banned, (path.name, n)
    code = (f"import sys; sys.path[:0] = [{str(BENCH)!r}]\n"
            "import reference.learner, reference.nets, reference.per\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert not set(eval(out.stdout.strip())) & banned
