"""The port's native PER trees (``d4pg_tpu_torch/replay/native.py``).

``native/per_trees.cpp`` compiled by the port with g++ into its own build
directory must agree bitwise with the numpy trees (the port's and the
reference's), take [K, B] chunk indices as K * B writes, land in
``d4pg_tpu_torch/replay/_build/`` under a name that hashes the source,
never touch the JAX package's ``d4pg_tpu/replay/_native/`` and never run
``make``; ``backend='auto'`` falls back to numpy when the library cannot
be built, ``'native'`` raises.
"""

import os
import subprocess
from pathlib import Path

import numpy as np
import pytest

from d4pg_tpu.replay import segment_tree as jtree
from d4pg_tpu_torch.replay import native
from d4pg_tpu_torch.replay import prioritized as tper
from d4pg_tpu_torch.replay import segment_tree as ttree

pytestmark = pytest.mark.torchport

ROOT = Path(__file__).resolve().parents[1]
JAX_NATIVE = ROOT / "d4pg_tpu" / "replay" / "_native"


def _listing(path: Path) -> dict:
    if not path.exists():
        return {}
    return {p.name: (p.stat().st_mtime_ns, p.stat().st_size)
            for p in path.iterdir()}


@pytest.mark.parametrize("cap", [1, 4096, 5000])
def test_native_matches_numpy_trees_bitwise(rng, cap):
    nat = native.NativePerTrees(cap)
    s, m = ttree.SumTree(cap), ttree.MinTree(cap)
    js = jtree.SumTree(cap)
    assert nat.capacity == s.capacity
    for _ in range(5):
        idx = rng.integers(0, cap, 500)  # duplicates: the last one wins
        vals = rng.random(500) + 1e-6
        for tree in (nat, s, m, js):
            tree.set(idx, vals)
        assert nat.sum() == s.sum() == js.sum()
        assert nat.min() == m.min()
        mass = rng.uniform(0, s.sum(), 128)
        mass[:2] = [0.0, s.sum()]
        np.testing.assert_array_equal(nat.find_prefixsum(mass),
                                      s.find_prefixsum(mass))
        np.testing.assert_array_equal(nat.find_prefixsum(mass),
                                      js.find_prefixsum(mass))
        probe = rng.integers(0, cap, 64)
        np.testing.assert_array_equal(nat.get(probe), s.get(probe))


def test_native_takes_chunk_shaped_indices(rng):
    """[K, B] indices are K * B writes (the C side takes an element
    count), in flat order; get and find keep the input's shape."""
    cap, k, b = 256, 4, 16
    nat, s = native.NativePerTrees(cap), ttree.SumTree(cap)
    idx = rng.integers(0, cap, (k, b))
    vals = rng.random((k, b)) + 1e-3
    nat.set(idx, vals)
    s.set(idx.ravel(), vals.ravel())
    assert nat.sum() == s.sum()
    assert nat.get(idx).shape == (k, b)
    np.testing.assert_array_equal(nat.get(idx), s.get(idx))
    mass = rng.uniform(0, s.sum(), (k, b))
    np.testing.assert_array_equal(nat.find_prefixsum(mass),
                                  s.find_prefixsum(mass))
    with pytest.raises(IndexError):
        nat.set(np.array([cap]), np.array([1.0]))
    with pytest.raises(ValueError):
        nat.set(np.array([0, 1]), np.array([1.0]))


def test_build_lands_in_the_port_build_dir_and_never_in_jax_native(
        tmp_path, monkeypatch):
    """A fresh build from the tracked source goes to the given build
    directory under a source-hashed name; it runs g++ only (no make) and
    leaves ``d4pg_tpu/replay/_native/`` exactly as it was."""
    assert native.BUILD_DIR == ROOT / "d4pg_tpu_torch" / "replay" / "_build"
    assert native.SOURCE == ROOT / "native" / "per_trees.cpp"
    assert native.library_path().parent == native.BUILD_DIR
    loaded = Path(native.library()._name)
    assert loaded.parent == native.BUILD_DIR
    assert loaded == native.library_path()

    before = _listing(JAX_NATIVE)
    commands = []
    run = subprocess.run

    def recording(cmd, *args, **kwargs):
        commands.append(cmd)
        return run(cmd, *args, **kwargs)

    monkeypatch.setattr(subprocess, "run", recording)
    lib = native.build(build_dir=tmp_path / "build")
    assert lib.parent == tmp_path / "build" and lib.exists()
    assert lib.name == native.library_path().name
    assert len(commands) == 1 and Path(commands[0][0]).name == "g++"
    assert not any("make" in str(part) for part in commands[0])
    assert str(native.SOURCE) in commands[0]
    assert native.build(build_dir=tmp_path / "build") == lib  # reused
    assert len(commands) == 1
    assert _listing(JAX_NATIVE) == before

    # an edited source gets its own library
    edited = tmp_path / "per_trees.cpp"
    edited.write_text(native.SOURCE.read_text() + "\n// edited\n")
    assert native.library_path(edited).name != lib.name


def test_auto_falls_back_to_numpy_and_native_raises(monkeypatch):
    def broken():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(native, "library", broken)
    buf = tper.PrioritizedReplayBuffer(16, 2, 1, backend="auto")
    assert buf.tree_backend == "numpy"
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tper.PrioritizedReplayBuffer(16, 2, 1, backend="native")


def test_default_backend_is_the_native_library():
    buf = tper.PrioritizedReplayBuffer(16, 2, 1)
    assert buf.tree_backend == "native"
    assert isinstance(buf._trees, native.NativePerTrees)
    assert os.path.commonpath([native.library()._name,
                               str(native.BUILD_DIR)]) == str(
        native.BUILD_DIR)
