"""The port's projection autotuner: the reference's policy
(tests/test_ingest.py's autotune cases) on the port.

An explicit flag passes through; ``auto`` on the CPU or for a mesh
learner resolves to ``einsum`` without timing; the measured path, forced
on the CPU, times each of the three arms on its own (``einsum`` is the
plain projection, ``pallas`` the projection kernel), as the reference
does; a candidate that fails raises instead of losing the race; one card
named ``cuda`` or ``cuda:0`` keys one cache entry, as the reference keys
by backend.
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


def test_measured_path_returns_float_timings(monkeypatch):
    """Forced on the CPU for coverage (the policy never times there):
    three arms, three separate timings."""
    timed = []
    time_variant = autotune._time_variant

    def recording(variant, *args):
        ms = time_variant(variant, *args)
        timed.append((variant, round(ms, 4)))
        return ms

    monkeypatch.setattr(autotune, "_time_variant", recording)
    r = autotune.autotune_projection(8, 0, 1, 11, repeats=1, iters=1,
                                     device="cpu")
    assert r.selected in autotune.CANDIDATES
    assert set(r.timings_ms) == set(autotune.CANDIDATES)
    assert all(isinstance(t, float) for t in r.timings_ms.values())
    assert sorted(timed) == sorted(r.timings_ms.items())
    assert [v for v, _ in timed] == list(autotune.CANDIDATES)


def test_cuda_and_cuda0_share_one_entry(monkeypatch):
    """One card under two names races once: the cache keys the resolved
    card (type and index), not the spelling."""
    races = []

    def race(batch_size, v_min, v_max, n_atoms, device=None, **kw):
        races.append(device)
        return autotune.AutotuneResult("pallas_ce", "raced", {})

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(autotune, "autotune_projection", race)
    monkeypatch.setattr(autotune, "_CACHE", {})
    for device in ("cuda", "cuda:0", torch.device("cuda", 0), "cuda"):
        r = autotune.select_projection("auto", **SHAPE, device=device)
        assert r.selected == "pallas_ce"
    assert len(races) == 1
    # another card races on its own
    autotune.select_projection("auto", **SHAPE, device="cuda:1")
    assert len(races) == 2


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
