"""The hot path's spans (``d4pg_tpu_torch/io/profiling.py``: ``span``,
``spans``) on the CPU, over a tiny pixel learner's fused chunks.

Spans are inert unless ``torch.profiler`` is on or ``spans.enable()`` was
called: then nothing is recorded and no profiler range is entered. Under
the profiler every span the path reaches is a kineto range of its name,
nested as the table links it, stamped on the profiler's clock and not a
user annotation. Spans change no number the chunk computes. The device
half (CUDA events, the host lead) runs here on stand-in events with a
scripted device clock; the card runs it for real (``benchmark/``'s
``--trace 1`` runs read it).
"""

import collections
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from d4pg_tpu_torch.io import profiling
from d4pg_tpu_torch.io.profiling import SPAN_NAMES, span, spans
from d4pg_tpu_torch.learner.loop import FusedLoop
from d4pg_tpu_torch.learner.state import D4PGConfig, init_state
from d4pg_tpu_torch.obs.registry import REGISTRY
from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
from d4pg_tpu_torch.replay.uniform import TransitionBatch

pytestmark = pytest.mark.torchport

SHAPE, ACT, CAPACITY, BATCH, K = (16, 16, 3), 2, 64, 8, 3
COMMON = {"learner.chunk", "learner.step", "sampler.draw", "replay.gather",
          "update", "update.augment", "update.target", "update.critic",
          "update.actor", "update.soft_targets", "model.encoder",
          "kernel.projection_ce.fwd"}
PER_ONLY = {"sampler.weights", "sampler.writeback", "kernel.descent"}
SLACK_NS = 50_000  # kineto converts its own clock to the wall clock's ns


@pytest.fixture(autouse=True)
def clean_table():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


def _learner(prioritized: bool, seed: int = 0, shared: bool = True,
             curl: bool = False):
    extra = (dict(crop_size=15, contrastive="curl") if curl
             else dict(augment="shift", share_encoder=shared))
    cfg = D4PGConfig(obs_dim=int(np.prod(SHAPE)), act_dim=ACT, v_min=-10.0,
                     v_max=10.0, n_atoms=11, hidden=(16, 16), pixels=True,
                     obs_shape=SHAPE, encoder_channels=(4, 4, 4, 4),
                     projection="pallas_ce", **extra)
    state = init_state(cfg, seed, "cpu")
    buf = FusedDeviceReplay(CAPACITY, SHAPE, ACT, prioritized=prioritized,
                            device="cpu")
    rng = np.random.default_rng(seed)
    n = 48
    buf.add(TransitionBatch(
        obs=rng.integers(0, 256, (n, *SHAPE), dtype=np.uint8),
        action=rng.uniform(-1, 1, (n, ACT)).astype(np.float32),
        reward=rng.uniform(-5, 5, n).astype(np.float32),
        next_obs=rng.integers(0, 256, (n, *SHAPE), dtype=np.uint8),
        done=np.zeros(n, np.float32),
        discount=np.full(n, 0.99 ** 3, np.float32)))
    buf.drain()
    loop = FusedLoop(cfg, buf, k=K, batch_size=BATCH,
                     generator=torch.Generator().manual_seed(seed),
                     prioritized=prioritized)
    return state, buf, loop


def _kineto(prof):
    out = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name() in SPAN_NAMES:
            out[e.name()].append(e)
    for evs in out.values():
        evs.sort(key=lambda e: e.start_ns())
    return out


class _CountingRange:
    entered = 0

    def __init__(self, name):
        pass

    def __enter__(self):
        _CountingRange.entered += 1

    def __exit__(self, *exc):
        pass


@pytest.mark.parametrize("prioritized", [True, False])
def test_inactive_spans_record_and_enter_nothing(prioritized, monkeypatch):
    events = []
    monkeypatch.setattr(profiling, "_Range", _CountingRange)
    monkeypatch.setattr(profiling.SpanTable, "_event",
                        lambda self: events.append(1))
    _CountingRange.entered = 0
    state, _, loop = _learner(prioritized)
    loop.run(state, 2 * K)
    assert _CountingRange.entered == 0 and events == []
    assert spans.records() == [] and spans.open == 0
    s = spans.summary()
    assert s["steps"] == 0 and s["spans"] == {} and s["lead_ms"] == []
    assert s["launches_per_step"] == {} and s["overflow"] == 0


@pytest.mark.parametrize("prioritized", [True, False])
def test_profiled_chunk_spans_are_kineto_ranges_nested_as_linked(
        prioritized):
    state, _, loop = _learner(prioritized)
    loop.run(state, K)  # warm-up outside the profiler records nothing
    assert spans.records() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loop.run(state, K)
    recs = spans.records()
    names = {r["name"] for r in recs}
    assert names == (COMMON | PER_ONLY if prioritized else COMMON)
    twins = _kineto(prof)
    by_name = collections.defaultdict(list)
    for r in recs:
        by_name[r["name"]].append(r)
    twin_of, gaps = {}, []
    for name, rs in by_name.items():
        assert len(twins[name]) == len(rs), name
        for r, e in zip(rs, twins[name]):
            # the table's stamps are on the profiler's clock: taken inside
            # the range (a preempted thread may stamp late, never outside)
            assert e.start_ns() - SLACK_NS <= r["start_ns"], name
            assert r["end_ns"] <= e.start_ns() + e.duration_ns() + SLACK_NS
            assert not e.is_user_annotation(), name
            gaps.append(abs(r["start_ns"] - e.start_ns()))
            twin_of[r["id"]] = e
    assert sorted(gaps)[len(gaps) // 2] < 1_000_000
    ids = {r["id"]: r for r in recs}
    for r in recs:
        if r["parent"] is None:
            assert r["name"] == "learner.chunk"
            continue
        parent, child = twin_of[r["parent"]], twin_of[r["id"]]
        assert parent.start_ns() <= child.start_ns()
        assert (child.start_ns() + child.duration_ns()
                <= parent.start_ns() + parent.duration_ns())
        assert ids[r["parent"]]["start_ns"] <= r["start_ns"]
        assert r["end_ns"] <= ids[r["parent"]]["end_ns"]
    # one step's spans share its identifier
    steps = [r for r in recs if r["name"] == "learner.step"]
    assert [r["step"] for r in steps] == list(range(K, 2 * K))
    for r in recs:
        if r["parent"] == steps[0]["id"]:
            assert r["step"] == K


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("prioritized", [True, False])
def test_span_counts_fit_the_chunk(prioritized, shared):
    state, _, loop = _learner(prioritized, shared=shared)
    spans.enable()
    loop.run(state, 2 * K)
    s = spans.summary()
    count = {name: d["count"] for name, d in s["spans"].items()}
    steps = 2 * K
    assert s["steps"] == steps and count["learner.chunk"] == 2
    for name in ("learner.step", "sampler.draw", "replay.gather", "update",
                 "update.augment", "update.target", "update.critic",
                 "update.actor", "update.soft_targets",
                 "kernel.projection_ce.fwd"):
        assert count[name] == steps, name
    # shared: one target encoder for both target heads, the critic's, one
    # for the actor's head and the critic's head at the actor's action;
    # unshared: target actor and critic, critic, actor, critic again
    assert count["model.encoder"] == (3 if shared else 5) * steps
    if prioritized:
        for name in ("sampler.weights", "sampler.writeback",
                     "kernel.descent"):
            assert count[name] == steps, name
    else:
        assert not PER_ONLY & set(count)
    for name, d in s["spans"].items():
        assert 0 <= d["self_ns"] <= d["host_ns"], name
        assert d["device_ms"] is None  # no CUDA here
    # the CPU runs the kernels' plain versions: no launch counted
    per_step = dict(s["launches_per_step"])
    assert per_step.pop("encoder.reused") == (2.0 if shared else 0.0)
    assert per_step.pop("contrastive.steps") == 0.0
    assert set(per_step) == {
        "descent", "projection", "projection_ce.fwd", "projection_ce.bwd"}
    assert all(v == 0 for v in per_step.values())


def test_a_curl_step_spans_its_contrastive_step_and_counts_it():
    state, _, loop = _learner(False, curl=True)
    spans.enable()
    loop.run(state, 2 * K)
    recs = spans.records()
    s = spans.summary()
    by_id = {r["id"]: r for r in recs}
    steps = 2 * K
    contrastive = [r for r in recs if r["name"] == "update.contrastive"]
    assert len(contrastive) == steps
    assert all(by_id[r["parent"]]["name"] == "update" for r in contrastive)
    # the key's forward inside it (the anchor's trunk runs on the actor
    # step's conv map); the target's conv map, the critic's and the
    # actor step's conv map before it
    inside = [r for r in recs if r["name"] == "model.encoder"
              and r["parent"] in {c["id"] for c in contrastive}]
    assert len(inside) == steps
    assert s["spans"]["model.encoder"]["count"] == 4 * steps
    assert s["spans"]["update.augment"]["count"] == steps
    per_step = s["launches_per_step"]
    assert per_step["contrastive.steps"] == 1.0
    assert per_step["encoder.reused"] == 3.0


@pytest.mark.parametrize("prioritized", [True, False])
def test_spans_change_no_number(prioritized):
    outs = []
    for on in (False, True):
        spans.reset()
        if on:
            spans.enable()
        state, buf, loop = _learner(prioritized, seed=3)
        m = loop.run(state, 2 * K)
        spans.disable()
        outs.append((m, buf.trees, state))
    (m0, t0, s0), (m1, t1, s1) = outs
    assert spans.summary()["steps"] == 2 * K
    for name in m0:
        assert torch.equal(m0[name], m1[name]), name
    if prioritized:
        for a, b in zip(t0, t1):
            assert torch.equal(a, b)
    for net in ("actor", "critic", "target_actor", "target_critic"):
        for a, b in zip(getattr(s0, net).parameters(),
                        getattr(s1, net).parameters()):
            assert torch.equal(a, b), net
    assert s0.step == s1.step


def test_registry_export_carries_spans():
    spans.enable()
    with span("learner.step").at(7):
        pass
    out = REGISTRY.export()
    assert out["spans"]["steps"] == 1
    assert out["spans"]["spans"]["learner.step"]["count"] == 1


def test_the_table_is_bounded_and_counts_overflow(monkeypatch):
    monkeypatch.setattr(spans, "capacity", 5)
    spans.enable()
    for _ in range(4):
        with span("learner.step"):
            with span("sampler.draw"):
                pass
    recs = spans.records()
    assert len(recs) == 5 and spans.overflow == 3
    assert spans.summary()["overflow"] == 3
    spans.reset()
    assert spans.records() == [] and spans.overflow == 0


def test_unknown_span_names_are_refused():
    with pytest.raises(KeyError, match="unknown span"):
        span("learner.nap")


def test_a_decorated_function_is_a_span():
    @span("update")
    def f(x):
        return x + 1

    assert f(1) == 2 and spans.records() == []
    spans.enable()
    assert f(2) == 3
    assert [r["name"] for r in spans.records()] == ["update"]


class _Event:
    """A CUDA event's stand-in: ``record`` reads the scripted device
    clock (``Device.now``)."""

    def __init__(self, device):
        self.device, self.t = device, None

    def record(self):
        self.t = self.device.now()

    def query(self):
        return self.t <= time.time_ns()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


class _Device:
    """The stream reaches each marker ``lag`` ns after the host records
    it; other events sit at the host's time plus the last lag."""

    def __init__(self, lags_ns):
        self.lags = list(lags_ns)
        self.lag = 0

    def now(self):
        return time.time_ns() + self.lag


def test_events_give_device_time_and_the_host_lead(monkeypatch):
    device = _Device([])
    monkeypatch.setattr(profiling, "_on_card", lambda: True)
    monkeypatch.setattr(profiling.SpanTable, "_event",
                        lambda self: _Event(device))
    lags = [4_000_000, 9_000_000, 2_500_000, 30_000_000]
    spans.enable()
    with span("learner.chunk"):
        for lag in lags:
            device.lag = lag
            with span("learner.step").at(0):
                with span("kernel.descent"):
                    pass
                with span("sampler.draw"):
                    time.sleep(0.001)
    s = spans.summary()
    # the least offset that keeps every marker at or after its host stamp
    # reads the tightest marker as 0; the others lead by their extra lag
    expect = [(lag - min(lags)) / 1e6 for lag in lags]
    # (1 ms of room: a preempted thread records its event late)
    assert s["lead_ms"] == pytest.approx(expect, abs=1.0)
    markers = spans.markers()
    assert len(markers) == len(lags)
    assert min(d - h for _, h, d in markers) == 0
    assert s["spans"]["sampler.draw"]["device_ms"] >= 4 * 1.0
    assert s["spans"]["kernel.descent"]["device_ms"] is None
    assert s["spans"]["learner.chunk"]["device_ms"] is not None


def test_events_the_device_has_passed_go_back_to_the_pool(monkeypatch):
    device = _Device([])
    made = []

    def event(self):
        with self._mu:
            if self._pool:
                return self._pool.pop()
        made.append(_Event(device))
        return made[-1]

    monkeypatch.setattr(profiling, "_on_card", lambda: True)
    monkeypatch.setattr(profiling.SpanTable, "_event", event)
    monkeypatch.setattr(spans, "_pool", [])  # no stand-ins of other tests
    spans.enable()
    for _ in range(50):
        with span("learner.step").at(0):
            with span("sampler.draw"):
                pass
            with span("update"):
                pass
    # each step's events are read at the next step's end and reused: the
    # table holds 150 spans on a handful of events
    assert len(made) <= 12
    s = spans.summary()
    assert s["steps"] == 50 and len(s["lead_ms"]) == 50
    assert all(d["device_ms"] is not None for d in s["spans"].values())


def _sharded(seed):
    from d4pg_tpu_torch.parallel import RankMesh
    from d4pg_tpu_torch.replay.sharded_per import ShardedFusedReplay

    cfg = D4PGConfig(obs_dim=4, act_dim=ACT, v_min=-10.0, v_max=10.0,
                     n_atoms=11, hidden=(16, 16), projection="einsum")
    mesh = RankMesh.local("cpu", 2)
    buf = ShardedFusedReplay(64, 4, ACT, mesh, alpha=0.6)
    rng = np.random.default_rng(seed)
    n = 48
    buf.add(TransitionBatch(
        obs=rng.standard_normal((n, 4)).astype(np.float32),
        action=rng.uniform(-1, 1, (n, ACT)).astype(np.float32),
        reward=rng.uniform(-5, 5, n).astype(np.float32),
        next_obs=rng.standard_normal((n, 4)).astype(np.float32),
        done=np.zeros(n, np.float32), discount=np.full(n, 0.99, np.float32)))
    buf.drain()
    loop = FusedLoop(cfg, buf, k=2, batch_size=BATCH,
                     generator=torch.Generator().manual_seed(seed),
                     mesh=mesh)
    return init_state(cfg, seed, "cpu"), buf, loop


def test_sharded_chunk_spans_and_no_number_moved():
    runs = []
    for on in (False, True):
        spans.reset()
        if on:
            spans.enable()
        state, buf, loop = _sharded(5)
        runs.append((loop.run(state, 4), buf.trees, state))
        spans.disable()
    count = {n: d["count"] for n, d in spans.summary()["spans"].items()}
    assert count == {"learner.chunk": 2, "learner.step": 4,
                     "sampler.draw": 4, "kernel.descent": 8,
                     "sampler.weights": 4, "collective.is_min": 4,
                     "replay.gather": 4, "update": 4, "update.target": 4,
                     "update.critic": 4, "update.actor": 4,
                     "update.soft_targets": 4, "sampler.writeback": 4}
    (m0, t0, s0), (m1, t1, s1) = runs
    for name in m0:
        assert torch.equal(m0[name], m1[name]), name
    for a, b in zip(t0, t1):
        assert torch.equal(a, b)
    for a, b in zip(s0.critic.parameters(), s1.critic.parameters()):
        assert torch.equal(a, b)


def test_the_gradient_average_and_the_projection_are_spans():
    from types import SimpleNamespace

    from d4pg_tpu_torch.learner.update import update_step
    from d4pg_tpu_torch.parallel.data_parallel import grad_reducer

    reduce = grad_reducer(SimpleNamespace(data_size=2,
                                          mean=lambda flat: None))
    cfg = D4PGConfig(obs_dim=4, act_dim=ACT, v_min=-10.0, v_max=10.0,
                     n_atoms=11, hidden=(16, 16), projection="pallas")
    state = init_state(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    batch = TransitionBatch(
        obs=torch.randn(BATCH, 4), action=torch.rand(BATCH, ACT) * 2 - 1,
        reward=torch.from_numpy(rng.uniform(-5, 5, BATCH).astype(np.float32)),
        next_obs=torch.randn(BATCH, 4), done=torch.zeros(BATCH),
        discount=torch.full((BATCH,), 0.99))
    spans.enable()
    update_step(cfg, state, batch, grad_reduce=reduce)
    recs = spans.records()
    ids = {r["id"]: r["name"] for r in recs}
    parents = {r["name"]: ids.get(r["parent"]) for r in recs}
    assert parents["kernel.projection"] == "update.critic"
    assert [r["name"] for r in recs].count("collective.grad_reduce") == 2
    assert parents["collective.grad_reduce"] in ("update.critic",
                                                 "update.actor")


def test_profile_dir_writes_the_spans_beside_the_trace(tmp_path):
    import json

    from d4pg_tpu_torch.train import profiled

    state, _, loop = _learner(True)
    spans.enable()
    with span("learner.step"):  # before the profiled steps: not written
        pass
    spans.disable()
    profiled(str(tmp_path), torch.device("cpu"), loop.run, state, K)
    traces = list(tmp_path.glob("trace_*.json"))
    written = list(tmp_path.glob("spans_*.json"))
    assert len(traces) == 1 and len(written) == 1
    assert written[0].name[len("spans_"):] == traces[0].name[len("trace_"):]
    summary = json.loads(written[0].read_text())
    assert summary["steps"] == K
    assert summary["spans"]["learner.chunk"]["count"] == 1
