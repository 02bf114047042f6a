"""The port stands alone: it imports with JAX blocked, loads nothing of the
JAX package, and its entry points refuse to run without a card unless the
caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.torchport

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "d4pg_tpu_torch"
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "d4pg_tpu"}

_IMPORT_ALL = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax"):
    sys.modules[name] = None  # any import of them raises ImportError
import d4pg_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(d4pg_tpu_torch.__path__,
                                              "d4pg_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
leaked = sorted(k for k in sys.modules
                if k == "d4pg_tpu" or k.startswith("d4pg_tpu."))
print(len(mods), leaked)
assert not leaked, leaked
"""


def test_port_imports_with_jax_blocked():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20  # every module of the package was imported


def test_port_sources_import_no_jax_or_reference():
    found = []
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [(path.name, n) for n in names
                      if n.split(".")[0] in BANNED]
    assert not found, found


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from d4pg_tpu_torch.learner.state import D4PGConfig, init_state
    from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = D4PGConfig(obs_dim=4, act_dim=2, hidden=(8, 8), n_atoms=5)
    with pytest.raises(RuntimeError, match="cuda"):
        init_state(cfg, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        FusedDeviceReplay(16, 4, 2)
    # an explicit CPU request runs
    state = init_state(cfg, 0, device="cpu")
    assert state.device.type == "cpu"
    buf = FusedDeviceReplay(16, 4, 2, device="cpu")
    assert buf.trees.sum_tree.shape == (32,)


def test_config_rejects_unported_projection():
    from d4pg_tpu_torch.learner.state import D4PGConfig

    with pytest.raises(NotImplementedError, match="not ported yet"):
        D4PGConfig(obs_dim=4, act_dim=2, projection="pallas_ce")
    with pytest.raises(ValueError):
        D4PGConfig(obs_dim=4, act_dim=2, projection="nope")


def test_tf32_is_off_once_the_port_is_imported():
    import d4pg_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_kernel_build_is_lazy_and_keyed_by_sources(tmp_path, monkeypatch):
    """Importing the ops builds nothing; the library name follows the
    sources, so an edited kernel is rebuilt rather than reused."""
    from d4pg_tpu_torch.ops import kernels

    assert kernels.library.cache_info().currsize == 0
    a = tmp_path / "a.cu"
    a.write_text("// one")
    first = kernels._digest([a])
    a.write_text("// two")
    assert kernels._digest([a]) != first
    assert {s.name for s in kernels.CSRC.glob("*.cu")} == {
        "projection.cu", "sampler_descent.cu"}
