"""The port stands alone: it imports with JAX and gymnasium blocked, loads
nothing of the JAX package, and its entry points refuse to run without a
card unless the caller asks for the CPU. gymnasium is imported only
inside the driver's ``make_env_fn``, for gymnasium ids."""

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
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "gymnasium"):
    sys.modules[name] = None  # any import of them raises ImportError
import d4pg_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(d4pg_tpu_torch.__path__,
                                              "d4pg_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
leaked = sorted(k for k in sys.modules
                if k == "d4pg_tpu" or k.startswith("d4pg_tpu."))
print(len(mods), leaked, " ".join(mods))
assert not leaked, leaked
"""

# modules the host replay path and the obs plane added; each must be
# among those imported with JAX blocked
HOST_PATH_AND_OBS = {
    "d4pg_tpu_torch.obs", "d4pg_tpu_torch.obs.registry",
    "d4pg_tpu_torch.obs.flight", "d4pg_tpu_torch.obs.containment",
    "d4pg_tpu_torch.obs.trace", "d4pg_tpu_torch.obs.draw_ledger",
    "d4pg_tpu_torch.replay.segment_tree", "d4pg_tpu_torch.replay.native",
    "d4pg_tpu_torch.replay.uniform", "d4pg_tpu_torch.replay.device_ring",
    "d4pg_tpu_torch.replay.prioritized", "d4pg_tpu_torch.replay.staging",
    "d4pg_tpu_torch.learner.pipeline",
}
# modules the HER recipe and the remote planes added
HER_AND_REMOTE = {
    "d4pg_tpu_torch.envs.her", "d4pg_tpu_torch.envs.normalizer",
    "d4pg_tpu_torch.envs.robotics_compat", "d4pg_tpu_torch.core.wire",
    "d4pg_tpu_torch.distributed.transport",
    "d4pg_tpu_torch.distributed.weight_server", "d4pg_tpu_torch.actor_main",
}
# the v2 weight plane (the sharded ingest plane adds no module)
WEIGHT_PLANE = {"d4pg_tpu_torch.distributed.weight_plane"}
# the serving plane, the sample-on-ingest dealt plane and the in-process
# learner plane
SERVING_DEALT_LEARNERS = {
    "d4pg_tpu_torch.serving.protocol", "d4pg_tpu_torch.serving.server",
    "d4pg_tpu_torch.replay.sampler", "d4pg_tpu_torch.replay.device_sampler",
    "d4pg_tpu_torch.learner.aggregator", "d4pg_tpu_torch.learner.replica",
}
# the elastic plane and its drill
ELASTIC = {
    "d4pg_tpu_torch.elastic", "d4pg_tpu_torch.elastic.traffic",
    "d4pg_tpu_torch.elastic.admission", "d4pg_tpu_torch.elastic.autoscaler",
    "d4pg_tpu_torch.elastic.ledger", "d4pg_tpu_torch.fleet.elastic_chaos",
}


# the rank mesh, the data-parallel learner and the sharded replay
PARALLEL = {
    "d4pg_tpu_torch.parallel", "d4pg_tpu_torch.parallel.mesh",
    "d4pg_tpu_torch.parallel.partition",
    "d4pg_tpu_torch.parallel.data_parallel",
    "d4pg_tpu_torch.parallel.multihost",
    "d4pg_tpu_torch.parallel.multihost_check",
    "d4pg_tpu_torch.replay.sharded_per",
}
# the replica and model axes: mesh-native replicas, their A/B drill and
# the split pixel encoder
MESH_AXES = {
    "d4pg_tpu_torch.learner.mesh_replicas", "d4pg_tpu_torch.fleet.mesh_ab",
    "d4pg_tpu_torch.parallel.model_axis",
}
# the fleet plane (harness, chaos policy, sweeps, drills) and offline
# analysis
FLEET_AND_ANALYSIS = {
    "d4pg_tpu_torch.fleet.chaos", "d4pg_tpu_torch.fleet.sender",
    "d4pg_tpu_torch.fleet.harness", "d4pg_tpu_torch.fleet.sweep",
    "d4pg_tpu_torch.fleet.weight_chaos", "d4pg_tpu_torch.fleet.serving_chaos",
    "d4pg_tpu_torch.fleet.sampler_chaos", "d4pg_tpu_torch.analysis",
    "d4pg_tpu_torch.analysis.ewma", "d4pg_tpu_torch.analysis.logger",
    "d4pg_tpu_torch.analysis.plots", "d4pg_tpu_torch.analysis.actor_scaling",
}


def test_port_imports_with_jax_blocked():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 80  # every module of the package was imported
    imported = set(out.stdout.split("] ", 1)[1].split())
    assert HOST_PATH_AND_OBS <= imported, HOST_PATH_AND_OBS - imported
    assert HER_AND_REMOTE <= imported, HER_AND_REMOTE - imported
    assert WEIGHT_PLANE <= imported, WEIGHT_PLANE - imported
    assert SERVING_DEALT_LEARNERS <= imported, \
        SERVING_DEALT_LEARNERS - imported
    assert ELASTIC <= imported, ELASTIC - imported
    assert PARALLEL <= imported, PARALLEL - imported
    assert MESH_AXES <= imported, MESH_AXES - imported
    assert FLEET_AND_ANALYSIS <= imported, FLEET_AND_ANALYSIS - imported


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


def test_gymnasium_is_imported_only_in_make_env_fn():
    found = []
    for path in PACKAGE.rglob("*.py"):
        tree = ast.parse(path.read_text(), str(path))
        owner = {}  # node -> innermost enclosing function (BFS: outer first)
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef):
                owner.update((id(n), fn.name) for n in ast.walk(fn))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            if any(n.split(".")[0] == "gymnasium" for n in names):
                found.append((path.name, owner.get(id(node))))
    assert found == [("train.py", "make_env_fn")]


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from d4pg_tpu_torch.core import noise
    from d4pg_tpu_torch.learner.state import D4PGConfig, init_state
    from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = D4PGConfig(obs_dim=4, act_dim=2, hidden=(8, 8), n_atoms=5)
    with pytest.raises(RuntimeError, match="cuda"):
        init_state(cfg, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        FusedDeviceReplay(16, 4, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        noise.gaussian.init()
    with pytest.raises(RuntimeError, match="cuda"):
        noise.ou.init(2)
    from d4pg_tpu_torch.fleet import run_elastic_chaos

    with pytest.raises(RuntimeError, match="cuda"):
        run_elastic_chaos(model_horizon_s=0.1)
    # an explicit CPU request runs
    state = init_state(cfg, 0, device="cpu")
    assert state.device.type == "cpu"
    buf = FusedDeviceReplay(16, 4, 2, device="cpu")
    assert buf.trees.sum_tree.shape == (32,)
    assert noise.ou.init(2, device="cpu").x.device.type == "cpu"


def test_mesh_axes_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """The replica placement and the A/B drill take every card by
    default and raise without one; an explicit CPU placement runs."""
    from d4pg_tpu_torch.fleet import run_mesh_ab
    from d4pg_tpu_torch.parallel import replica_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        replica_mesh(2)
    with pytest.raises(RuntimeError, match="cuda"):
        run_mesh_ab(rounds=1)
    assert replica_mesh(3, ["cpu"]) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        replica_mesh(0, ["cpu"])


def test_config_rejects_unported_projection():
    """Every arm of the reference is ported (``pallas_ce`` last); an
    unknown name, and an unresolved ``auto``, still raise."""
    from d4pg_tpu_torch.learner.state import D4PGConfig

    for arm in ("einsum", "pallas", "pallas_ce"):
        assert D4PGConfig(obs_dim=4, act_dim=2, projection=arm).projection \
            == arm
    for name in ("nope", "auto"):
        with pytest.raises(ValueError, match="unknown projection"):
            D4PGConfig(obs_dim=4, act_dim=2, projection=name)


def test_tf32_is_off_once_the_port_is_imported():
    import d4pg_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_kernel_build_is_lazy_and_keyed_by_sources(tmp_path, monkeypatch):
    """Importing the ops builds nothing; the library name follows the
    sources, headers included, so an edited kernel or shared header is
    rebuilt rather than reused."""
    from d4pg_tpu_torch.ops import kernels

    assert kernels.library.cache_info().currsize == 0
    a = tmp_path / "a.cu"
    a.write_text("// one")
    first = kernels._digest([a])
    a.write_text("// two")
    assert kernels._digest([a]) != first
    assert {s.name for s in kernels.CSRC.glob("*.cu")} == {
        "projection.cu", "projection_ce.cu", "sampler_descent.cu"}
    assert {s.name for s in kernels.CSRC.glob("*.cuh")} == {
        "projection_common.cuh"}
    # a copy of the sources: editing the shared header renames the library
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in kernels.CSRC.iterdir():
        (csrc / src.name).write_bytes(src.read_bytes())
    assert kernels.library_path(csrc) == kernels.library_path()
    header = csrc / "projection_common.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert kernels.library_path(csrc) != kernels.library_path()
    assert kernels.library.cache_info().currsize == 0
