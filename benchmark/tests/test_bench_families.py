"""Every model family is a file of its own (``families/<family>.py``),
found by the configuration's ``family``: each gives the whole interface,
its networks are the program's, its reference side loads nothing of the
program, and no generic module of the harness branches on a family."""

from __future__ import annotations

import ast
import inspect
import re
import subprocess
import sys

import pytest
import torch

from bench_tiny import BENCH, tiny
from harness import inputs, spec

FAMILIES = sorted(p.stem for p in (BENCH / "families").glob("*.py"))
INTERFACE = ("program_config", "program_nets", "LOSSES", "layout",
             "init_scale", "tie", "observations", "draws", "apply_draws",
             "Learner", "tiny")
GENERIC = ("harness/program.py", "harness/inputs.py", "harness/check.py",
           "harness/learn.py", "harness/spec.py", "runners/fused_learner.py",
           "reference/learner.py", "tests/bench_tiny.py", "run.py")
FAMILY_WORDS = {"pixels", "augment", "shift"}


def configs() -> list[str]:
    return sorted(p.stem for p in (BENCH / "configs").glob("*.json"))


def tiny_config(name: str):
    """A configuration's tiny cell under the first traffic that fits."""
    cfg = spec.load_json(BENCH / "configs" / f"{name}.json")
    tr = spec.load_json(BENCH / "traffic" / "per.b512.json")
    return tiny(spec.Cell(name=name, chips=1, config=cfg, traffic=tr,
                          end_to_end=[], per_layer=[], limits={}))


def test_every_configuration_names_a_family_with_a_file():
    assert FAMILIES
    for name in configs():
        cfg = spec.load_json(BENCH / "configs" / f"{name}.json")
        assert cfg["family"] in FAMILIES, (name, cfg["family"])


@pytest.mark.parametrize("family", FAMILIES)
def test_a_family_gives_the_whole_interface(family):
    mod = spec.plugin("families", family)
    missing = [n for n in INTERFACE if not hasattr(mod, n)]
    assert not missing, missing
    assert isinstance(mod.LOSSES, tuple) and mod.LOSSES
    assert all(isinstance(n, str) for n in mod.LOSSES)
    assert inspect.isclass(mod.Learner)
    for name in INTERFACE:
        if name not in ("LOSSES", "Learner"):
            assert callable(getattr(mod, name)), name


@pytest.mark.parametrize("config", configs())
def test_the_familys_networks_are_the_programs(config):
    from d4pg_tpu_torch.learner.state import init_state

    cell = tiny_config(config)
    cfg = cell.config
    family = spec.family(cfg)
    params = inputs.make_params(cfg, 3, torch.device("cpu"))
    state = init_state(family.program_config(cfg), 0, "cpu")
    nets = family.program_nets(state)
    assert list(nets) == list(family.layout(cfg)) == list(params)
    for net, (online, target, opt) in nets.items():
        want = {k: tuple(v.shape) for k, v in online.state_dict().items()}
        assert want == {k: tuple(v.shape) for k, v in params[net].items()}
        assert target is None or target.state_dict().keys() == want.keys()
        assert isinstance(opt, torch.optim.Optimizer)
    learner = family.Learner(cfg, params)
    assert list(learner.p) == list(params)


REFERENCE_SIDE = """
import sys
sys.path[:0] = [{tests!r}]
import torch
from bench_tiny import tiny
from harness import inputs, spec
dev = torch.device("cpu")
for name in {configs!r}:
    cfg = spec.load_json(spec.BENCH / "configs" / (name + ".json"))
    tr = spec.load_json(spec.BENCH / "traffic" / "per.b512.json")
    cell = tiny(spec.Cell(name, 1, cfg, tr, [], [], {{}}))
    cfg, tr = cell.config, cell.traffic
    family = spec.family(cfg)
    params = inputs.make_params(cfg, 1, dev)
    draws = family.draws(cfg, tr, inputs.generator(dev, 1, "state"), dev, 1)
    b = int(tr["batch_size"])
    row = inputs.rows_block(cfg, tr, 1, 0, 0, b, dev)
    row = family.apply_draws(cfg, row, draws, 0, slice(0, b))
    res = family.Learner(cfg, params).step([row])
    assert sorted(res["losses"]) == sorted(family.LOSSES), res["losses"]
print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_a_familys_reference_side_loads_nothing_of_the_program():
    code = REFERENCE_SIDE.format(tests=str(BENCH / "tests"),
                                 configs=configs())
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("LOADED")][-1]
    loaded = set(eval(line[len("LOADED "):]))
    assert "d4pg_tpu_torch" not in loaded


def _code_words(tree: ast.AST) -> list[str]:
    """Identifiers and the strings that are not docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and \
                    isinstance(first.value, ast.Constant):
                docs.add(id(first.value))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            out.append(node.id)
        elif isinstance(node, ast.Attribute):
            out.append(node.attr)
        elif isinstance(node, ast.arg):
            out.append(node.arg)
        elif isinstance(node, ast.keyword) and node.arg:
            out.append(node.arg)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.append(node.name)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            out.append(node.value)
    return out


@pytest.mark.parametrize("module", GENERIC)
def test_no_generic_module_branches_on_a_family(module):
    tree = ast.parse((BENCH / module).read_text())
    for word in _code_words(tree):
        tokens = set(re.split(r"[^A-Za-z0-9]+|_", word.lower()))
        assert not tokens & FAMILY_WORDS, (module, word)
        assert not any(f in word for f in FAMILIES), (module, word)
