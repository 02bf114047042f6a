"""The port's projection autotuner: the reference's policy
(tests/test_ingest.py's autotune cases) on the port.

An explicit flag passes through; ``auto`` on the CPU or for a mesh
learner resolves to ``einsum`` without timing; the measured path, forced
on the CPU, returns float timings with ``einsum`` and ``pallas`` timed
once as the one path they are in the port; a candidate that fails
raises instead of losing the race.
"""

import pytest
import torch

from d4pg_tpu.ops.autotune import select_projection as jax_select_projection
from d4pg_tpu_torch.ops import autotune

pytestmark = pytest.mark.torchport

SHAPE = dict(batch_size=64, v_min=0, v_max=1, n_atoms=11)


@pytest.mark.parametrize("flag", ["einsum", "pallas", "pallas_ce"])
def test_explicit_override_passes_through(flag):
    r = autotune.select_projection(flag, **SHAPE, device="cpu")
    assert r.selected == flag and "override" in r.reason
    assert r.timings_ms is None
    assert jax_select_projection(flag, **SHAPE).selected == flag


def test_static_policy_on_cpu_and_on_mesh():
    r = autotune.select_projection("auto", **SHAPE, device="cpu")
    assert r.selected == "einsum" and r.timings_ms is None
    assert "cpu" in r.reason
    # the reference resolves the same way off its accelerator
    assert jax_select_projection("auto", **SHAPE).selected == r.selected
    r = autotune.select_projection("auto", **SHAPE, mesh=True, device="cpu")
    assert r.selected == "einsum" and "partitioning" in r.reason
    assert autotune.autotune_block()["surfaces"]["projection"] == r.as_json()


def test_select_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        autotune.select_projection("auto", **SHAPE)


def test_measured_path_returns_float_timings():
    """Forced on the CPU for coverage (the policy never times there)."""
    r = autotune.autotune_projection(8, 0, 1, 11, repeats=1, iters=1,
                                     device="cpu")
    assert r.selected in autotune.CANDIDATES
    assert set(r.timings_ms) == set(autotune.CANDIDATES)
    assert all(isinstance(t, float) for t in r.timings_ms.values())
    assert r.timings_ms["einsum"] == r.timings_ms["pallas"]
    assert "one path" in r.reason


def test_failing_candidate_raises(monkeypatch):
    """A kernel that fails must surface, not quietly lose the race."""
    def broken(*args):
        raise RuntimeError("projection_ce kernel launch failed")

    monkeypatch.setattr(autotune, "projection_ce", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        autotune.autotune_projection(8, 0, 1, 11, repeats=1, iters=1,
                                     device="cpu")


def test_loss_cores_agree():
    """Both timed cores compute the same loss value."""
    sup = autotune.CategoricalSupport(0.0, 1.0, 11)
    g = torch.Generator().manual_seed(0)
    tp = torch.softmax(torch.randn(8, 11, generator=g), -1)
    pred = torch.softmax(torch.randn(8, 11, generator=g), -1)
    r, d = torch.rand(8, generator=g), torch.full((8,), 0.99)
    losses = [autotune._loss_fn(v, sup)(pred, tp, r, d)
              for v in autotune.CANDIDATES]
    torch.testing.assert_close(losses[0], losses[2])
    torch.testing.assert_close(losses[1], losses[2])
