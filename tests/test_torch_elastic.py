"""Port vs reference: the elastic plane (``d4pg_tpu_torch/elastic``).

The reference's ``tests/test_elastic.py`` re-asserted on the port (all
but ``test_elastic_artifact_schema``, which reads the committed artifact);
parity against ``d4pg_tpu.elastic`` from the same seeds: traffic traces
and arrival schedules bitwise, admission classes equal, the pure
controller's decision streams and final states equal over seeded signal
vectors, and ledgers that digest equal and replay under the other
package; the port's planes under the policy (class-attributed shedding
over two shards, ``set_ingest_depth`` waking a blocked producer, the
policy server's ``STATUS_OVERLOAD`` and its live knobs); the driver's
``--autoscale 1`` with every knob wired (read back from its owner), the
replica park and respawn under a scripted sensor; and the elastic drill
at a reduced horizon, asserting only what is deterministic (not the A/B
gate, which depends on the host's timing). Everything runs on the CPU.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from d4pg_tpu.elastic import admission as jadmission
from d4pg_tpu.elastic import autoscaler as jautoscaler
from d4pg_tpu.elastic import traffic as jtraffic
from d4pg_tpu_torch import train as ttrain
from d4pg_tpu_torch.config import ExperimentConfig
from d4pg_tpu_torch.core import locking
from d4pg_tpu_torch.distributed.replay_service import ReplayService
from d4pg_tpu_torch.distributed.weights import WeightStore
from d4pg_tpu_torch.elastic.admission import AdmissionPolicy
from d4pg_tpu_torch.elastic.autoscaler import (
    KNOBS,
    Autoscaler,
    AutoscalerConfig,
    ControlPolicy,
    extract_signals,
    replay_decisions,
    replay_matches,
)
from d4pg_tpu_torch.elastic.ledger import ScalingLedger, canonical_record
from d4pg_tpu_torch.elastic.traffic import TrafficConfig, TrafficModel
from d4pg_tpu_torch.learner import state as tstate
from d4pg_tpu_torch.obs.flight import RECORDER as FLIGHT
from d4pg_tpu_torch.obs.registry import REGISTRY
from d4pg_tpu_torch.replay.uniform import ReplayBuffer, TransitionBatch
from d4pg_tpu_torch.serving import (
    ActorConfig,
    PolicyInferenceServer,
    RemotePolicyClient,
)

pytestmark = pytest.mark.torchport

ROOT = Path(__file__).resolve().parents[1]


# --- the reference's tests/test_elastic.py on the port ---------------------

def test_traffic_model_deterministic():
    """Two models from one config give bit-identical offered load, per
    lane and summed; another seed does not."""
    cfg = TrafficConfig(seed=7, n_actors=6, diurnal_amp=0.3,
                        flash_rate_per_s=0.5, horizon_s=30.0)
    a, b = TrafficModel(cfg), TrafficModel(cfg)
    for lane in range(cfg.n_actors):
        assert np.array_equal(a.trace(lane, 20.0, 0.1),
                              b.trace(lane, 20.0, 0.1))
    assert np.array_equal(a.fleet_trace(20.0, 0.1), b.fleet_trace(20.0, 0.1))
    assert a.flash_events() == b.flash_events()
    other = TrafficModel(TrafficConfig(seed=8, n_actors=6, diurnal_amp=0.3,
                                       flash_rate_per_s=0.5, horizon_s=30.0))
    assert not np.array_equal(a.fleet_trace(20.0, 0.1),
                              other.fleet_trace(20.0, 0.1))


def test_flash_crowd_shape():
    """A scripted crowd multiplies the rate by its amplitude while active;
    overlapping crowds take the max, not the product."""
    cfg = TrafficConfig(seed=0, n_actors=1, diurnal_amp=0.0,
                        pareto_alpha=1e9,  # weight -> 1: the flash alone
                        flash_schedule=((2.0, 1.0, 6.0), (2.5, 1.0, 4.0)))
    m = TrafficModel(cfg)
    base = m.rate(0, 0.0)
    assert base == pytest.approx(cfg.base_rows_per_sec, rel=1e-6)
    assert m.rate(0, 2.4) == pytest.approx(6.0 * base)
    assert m.rate(0, 2.7) == pytest.approx(6.0 * base)  # overlap: max(6, 4)
    assert m.rate(0, 3.2) == pytest.approx(4.0 * base)  # the first is over
    assert m.rate(0, 4.0) == pytest.approx(base)        # both are over


def test_pareto_tail_and_floor():
    """The lane weights: mean 1, a few hot lanes, and the rate floor holds
    through the deepest diurnal trough."""
    cfg = TrafficConfig(seed=3, n_actors=256, pareto_alpha=1.5)
    m = TrafficModel(cfg)
    w = np.array([m.pareto_weight(i) for i in range(cfg.n_actors)])
    assert w.mean() == pytest.approx(1.0)
    assert np.all(w > 0)
    assert w.max() / np.median(w) > 3.0
    top = np.sort(w)[-cfg.n_actors // 10:]
    assert top.sum() / w.sum() > 0.2
    floor = TrafficModel(TrafficConfig(
        seed=3, n_actors=1, diurnal_amp=1.0, min_rows_per_sec=5.0,
        base_rows_per_sec=1.0))
    ts = np.arange(0.0, 120.0, 0.25)
    assert min(floor.rate(0, float(t)) for t in ts) >= 5.0


def test_renewal_flash_stream():
    """The unscripted flash stream: every event inside the horizon, with
    its duration and amplitude in their bands, and it replays."""
    cfg = TrafficConfig(seed=11, flash_rate_per_s=0.5, horizon_s=40.0,
                        flash_duration_s=(1.0, 2.0), flash_amp=(3.0, 5.0))
    ev = TrafficModel(cfg).flash_events()
    assert ev and ev == TrafficModel(cfg).flash_events()
    for start, dur, amp in ev:
        assert 0.0 < start < cfg.horizon_s
        assert 1.0 <= dur <= 2.0
        assert 3.0 <= amp <= 5.0


def test_admission_policy_classes():
    pol = AdmissionPolicy()
    assert [pol.classify_index(i) for i in range(4)] == [0, 1, 0, 1]
    assert pol.classify_actor("actor-3") == pol.classify_index(3)
    assert pol.classify_actor("proc-12") == pol.classify_index(12)
    assert pol.classify_actor("learner") == pol.classify_actor("learner")
    assert pol.class_name(0) == "rt" and pol.class_name(1) == "bulk"
    assert pol.depth_for(0, 96) == 96
    assert pol.depth_for(1, 96) == 48
    assert pol.depth_for(1, 1) == 1
    with pytest.raises(ValueError):
        AdmissionPolicy(classes=("a",), depth_fracs=(1.0, 0.5))
    with pytest.raises(ValueError):
        AdmissionPolicy(classes=("a", "b"), depth_fracs=(1.0, 0.0))


def test_shed_victim_no_priority_inversion():
    pol = AdmissionPolicy()
    assert pol.shed_victim([0, 1, 0, 1], incoming_cls=0) == 1
    assert pol.shed_victim([0, 0, 0], incoming_cls=1) is None
    assert pol.shed_victim([], incoming_cls=0) is None
    assert pol.shed_victim([1, 1], incoming_cls=1) == 0


def _signals(queue=0.0, p95=0.0, depth=0.0, sheds=0.0):
    return {"serving_queue": queue, "serving_p95_ms": p95,
            "ingest_depth_frac": depth, "ingest_sheds": sheds}


def test_control_policy_hysteresis_and_cooldown():
    cfg = AutoscalerConfig(serving_rows_init=32, serving_rows_min=16,
                           serving_rows_max=128, cooldown_ticks=2)
    pol = ControlPolicy(cfg)
    state = pol.initial_state()
    hot = _signals(queue=cfg.queue_high + 1)
    dec, state = pol.decide(hot, state)
    assert dec["serving_rows"] == 64
    assert dec["serving_window_s"] == cfg.serving_window_hot_s
    dec, state = pol.decide(hot, state)  # inside the cooldown
    assert "serving_rows" not in dec
    dec, state = pol.decide(hot, state)
    assert dec["serving_rows"] == 128
    dec, state = pol.decide(hot, state)
    dec, state = pol.decide(hot, state)
    assert "serving_rows" not in dec  # pinned at the max
    mid = _signals(queue=(cfg.queue_low + cfg.queue_high) // 2)
    for _ in range(4):  # the hysteresis gap holds position
        dec, state = pol.decide(mid, state)
        assert "serving_rows" not in dec
    dec, state = pol.decide(_signals(), state)
    assert dec["serving_rows"] == 64
    assert dec["serving_window_s"] == cfg.serving_window_cold_s


def test_control_policy_ingest_and_dealer():
    """Ingest pressure deepens the deques and paces the dealer down; calm
    reverses both; a shed-counter delta alone is pressure."""
    cfg = AutoscalerConfig(ingest_capacity_init=64, dealer_deals_init=2,
                           dealer_deals_max=4, cooldown_ticks=0)
    pol = ControlPolicy(cfg)
    state = pol.initial_state()
    dec, state = pol.decide(_signals(sheds=5.0), state)
    assert dec["ingest_capacity"] == 128
    assert dec["dealer_deals"] == 1
    dec, state = pol.decide(_signals(sheds=5.0), state)  # delta 0 now
    assert dec["ingest_capacity"] == 64
    assert dec["dealer_deals"] == 2


def test_extract_signals_total():
    """A missing provider, a provider_error section or garbage read as a
    calm plane."""
    assert extract_signals({}) == _signals()
    assert extract_signals({"serving": {"provider_error": "x"},
                            "ingest": None}) == _signals()
    sig = extract_signals({
        "serving": {"queue_depth": 3, "latency_ms": {"p95": "nan?"}},
        "ingest": {"sheds": 2, "admit_fails": 1,
                   "per_shard": [{"queue_depth": 5, "capacity": 10},
                                 {"queue_depth": 1, "capacity": 0}]},
    })
    assert sig["serving_queue"] == 3.0
    assert sig["serving_p95_ms"] == 0.0
    assert sig["ingest_depth_frac"] == 0.5
    assert sig["ingest_sheds"] == 3.0


def _snapshot_of(sig: dict) -> dict:
    """A registry-shaped export that ``extract_signals`` maps back onto
    ``sig``."""
    return {
        "serving": {"queue_depth": sig["serving_queue"],
                    "latency_ms": {"p95": sig["serving_p95_ms"]}},
        "ingest": {"sheds": sig["ingest_sheds"], "admit_fails": 0,
                   "per_shard": [{"queue_depth": sig["ingest_depth_frac"],
                                  "capacity": 1.0}]},
    }


def _scripted(scaler_cls, cfg, script, ledger_cls, **kw):
    scaler = scaler_cls(cfg, actuators={}, sensor=lambda: {},
                        ledger=ledger_cls(), register_provider=False, **kw)
    for sig in script:
        scaler._sensor = lambda s=sig: _snapshot_of(s)
        scaler.tick_once()
    return scaler


LEDGER_SCRIPT = ([_signals(queue=50.0, p95=80.0)] * 4 + [_signals()] * 4
                 + [_signals(depth=0.9, sheds=3.0)] * 4)


def test_ledger_replay_oracle_and_tamper():
    """A scripted sensor's ledger replays through the pure controller; the
    digest pins across two runs; a tampered decision breaks the oracle;
    wall time stays out of the canonical stream."""
    cfg = AutoscalerConfig(cooldown_ticks=1)
    a = _scripted(Autoscaler, cfg, LEDGER_SCRIPT, ScalingLedger)
    b = _scripted(Autoscaler, cfg, LEDGER_SCRIPT, ScalingLedger)
    assert len(a.ledger) == len(LEDGER_SCRIPT)
    assert replay_matches(cfg, a.ledger)
    assert a.ledger.digest() == b.ledger.digest()
    stats = a.autoscaler_stats()
    assert stats["decisions"] > 0 and stats["actuations"] == 0
    recs = a.ledger.records()
    victim = next(r for r in recs if r["decisions"])
    tampered = ScalingLedger()
    for r in recs:
        if r is victim:
            r = dict(r, decisions={k: v + 1
                                   for k, v in r["decisions"].items()})
        tampered.append(r)
    assert not replay_matches(cfg, tampered)
    assert tampered.digest() != a.ledger.digest()
    assert "t_wall" in recs[0] and "t_wall" not in canonical_record(recs[0])


def test_autoscaler_actuation_bounded_and_contained():
    """Wired actuators get exactly the decided targets; one that raises is
    degraded and counted, its decision still journaled; an unknown knob
    fails at construction."""
    cfg = AutoscalerConfig(cooldown_ticks=0)
    seen: list = []

    def boom(v):
        raise RuntimeError("actuator down")

    scaler = Autoscaler(
        cfg,
        actuators={"serving_rows": seen.append, "ingest_capacity": boom},
        sensor=lambda: {"serving": {"queue_depth": 99,
                                    "latency_ms": {"p95": 500.0}},
                        "ingest": {"sheds": 1, "per_shard": [
                            {"queue_depth": 9, "capacity": 10}]}},
        register_provider=False)
    rec = scaler.tick_once()
    assert seen == [rec["decisions"]["serving_rows"]]
    assert rec["errors"] and "ingest_capacity" in rec["errors"][0]
    assert scaler.stats["actuator_errors"] == 1
    assert replay_matches(cfg, scaler.ledger)
    with pytest.raises(ValueError):
        Autoscaler(cfg, actuators={"warp_factor": seen.append},
                   register_provider=False)


def test_live_capacity_setters():
    """The actuation surface on the port's planes: the ingest-depth resize
    recomputes the watermark under the shard conditions, and the dealer's
    pacing clamps at >= 1."""
    from d4pg_tpu_torch.replay.sampler import SampleDealer
    from d4pg_tpu_torch.replay.staging import DealtBlockRing

    svc = ReplayService(ReplayBuffer(512, 3, 2, seed=0), ingest_capacity=8,
                        shed_watermark=0.75, num_ingest_shards=2)
    try:
        svc.set_ingest_depth(64)
        stats = svc.ingest_stats()
        assert stats["ingest_capacity"] == 64
        for sh in stats["per_shard"]:
            assert sh["capacity"] == 64 and sh["shed_at"] == 48
        svc.set_ingest_depth(0)  # clamps: never a zero-capacity shard
        assert svc.ingest_stats()["ingest_capacity"] == 1
    finally:
        svc.close()
    dealer = SampleDealer(512, [DealtBlockRing(2)], n_shards=1, k=2,
                          batch_size=4, min_size=4, seed=0)
    dealer.set_pacing(3)
    assert dealer.max_deals_per_tick == 3
    dealer.set_pacing(-5)
    assert dealer.max_deals_per_tick == 1


# --- the autoscaler thread ---------------------------------------------------

def test_autoscaler_thread_provider_and_contained_crash():
    """The thread ticks on its interval and publishes the ``elastic``
    provider until ``close``; an exception escaping a tick ends the thread
    through ``contained_crash`` (counted), never the process."""
    scaler = Autoscaler(AutoscalerConfig(interval_s=0.01),
                        sensor=lambda: {}).start()
    try:
        deadline = time.monotonic() + 5.0
        while scaler.autoscaler_stats()["ticks"] < 3:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        block = REGISTRY.export()["elastic"]
        assert block["ticks"] >= 3 and set(block["targets"]) == set(KNOBS)
        assert block["ledger_records"] >= 3 and block["ledger_digest"]
    finally:
        scaler.close()
    assert "elastic" not in REGISTRY.export()
    before = REGISTRY.counter("threads.contained_crashes").value
    crashing = Autoscaler(AutoscalerConfig(interval_s=0.01),
                          sensor=lambda: {}, register_provider=False)

    def bad_decide(signals, state):
        raise RuntimeError("controller bug")

    crashing._policy.decide = bad_decide
    crashing.start()
    crashing._thread.join(timeout=5.0)
    assert not crashing._thread.is_alive()
    assert REGISTRY.counter("threads.contained_crashes").value == before + 1
    assert any(e["kind"] == "thread_crash_contained"
               and e["role"] == "elastic.autoscaler" for e in FLIGHT.events())
    crashing.close()


def test_a_sensor_that_raises_reads_as_a_calm_plane():
    def broken():
        raise OSError("registry down")

    scaler = Autoscaler(AutoscalerConfig(), sensor=broken,
                        register_provider=False)
    rec = scaler.tick_once()
    assert rec["signals"] == _signals()
    assert scaler.stats["sense_errors"] == 1


# --- parity against d4pg_tpu.elastic ------------------------------------------

TRAFFIC_CONFIGS = [
    dict(seed=7, n_actors=6, diurnal_amp=0.3, flash_rate_per_s=0.5,
         horizon_s=30.0),
    dict(seed=123, n_actors=16, base_rows_per_sec=480.0, diurnal_amp=0.1,
         diurnal_period_s=12.0, horizon_s=3.0,
         flash_schedule=((1.0, 0.8, 8.0), (1.5, 1.0, 5.0))),
    dict(seed=2, n_actors=8, pareto_alpha=1.1, diurnal_amp=0.9,
         min_rows_per_sec=3.0, flash_duration_s=(0.5, 4.0),
         flash_amp=(2.0, 20.0), flash_rate_per_s=0.2, horizon_s=120.0),
]


def _arrivals(model, lane: int, rows: int, horizon: float) -> np.ndarray:
    """A pump's arrival schedule: the model-clock recurrence
    t += rows / rate(t) up to the horizon."""
    t, out = 0.0, []
    while t < horizon:
        out.append(t)
        t += rows / max(1e-6, float(model.rate(lane, t)))
    return np.array(out, np.float64)


@pytest.mark.parametrize("kw", TRAFFIC_CONFIGS, ids=["renewal", "two_flash",
                                                     "heavy_tail"])
def test_traffic_traces_bitwise_the_reference(kw):
    port = TrafficModel(TrafficConfig(**kw))
    ref = jtraffic.TrafficModel(jtraffic.TrafficConfig(**kw))
    horizon = min(kw["horizon_s"], 40.0)
    assert port.flash_events() == ref.flash_events()
    grid = np.arange(0.0, horizon, horizon / 997.0)
    for lane in range(kw["n_actors"]):
        assert port.pareto_weight(lane) == ref.pareto_weight(lane)
        assert np.array_equal(
            np.array([port.rate(lane, float(t)) for t in grid]),
            np.array([ref.rate(lane, float(t)) for t in grid]))
        assert np.array_equal(port.trace(lane, horizon, 0.05),
                              ref.trace(lane, horizon, 0.05))
        assert np.array_equal(_arrivals(port, lane, 8, horizon),
                              _arrivals(ref, lane, 8, horizon))
    assert np.array_equal(port.fleet_trace(horizon, 0.1),
                          ref.fleet_trace(horizon, 0.1))


def test_traffic_construction_draws_are_counted_as_the_reference():
    from d4pg_tpu.obs.draw_ledger import LEDGER as JLEDGER
    from d4pg_tpu_torch.obs.draw_ledger import LEDGER

    for kw in TRAFFIC_CONFIGS:
        LEDGER.reset(armed=True)
        JLEDGER.reset(armed=True)
        TrafficModel(TrafficConfig(**kw))
        jtraffic.TrafficModel(jtraffic.TrafficConfig(**kw))
        assert LEDGER.counts() == JLEDGER.counts()
        assert LEDGER.digest("schedule.") == JLEDGER.digest("schedule.")
        assert LEDGER.counts()["schedule.traffic.pareto"] == kw["n_actors"]


def _identities(seed: int, n: int = 200) -> list:
    rng = np.random.default_rng(seed)
    ids = []
    for i in range(n):
        kind = i % 4
        if kind == 0:
            ids.append(f"actor-{int(rng.integers(0, 10_000))}")
        elif kind == 1:
            ids.append(f"proc-{int(rng.integers(0, 64))} ")
        elif kind == 2:
            ids.append(rng.bytes(6).hex() + "x")  # no trailing integer
        else:
            ids.append(f"elastic-{int(rng.integers(0, 4096))}")
    return ids


@pytest.mark.parametrize("classes,fracs", [
    (("rt", "bulk"), (1.0, 0.5)),
    (("gold", "silver", "bronze"), (1.0, 0.6, 0.25)),
])
def test_admission_classes_equal_the_reference(classes, fracs):
    port = AdmissionPolicy(classes=classes, depth_fracs=fracs)
    ref = jadmission.AdmissionPolicy(classes=classes, depth_fracs=fracs)
    rng = np.random.default_rng(5)
    lanes = [int(x) for x in rng.integers(0, 1 << 12, 200)]
    for lane in lanes:
        assert port.classify_index(lane) == ref.classify_index(lane)
    for actor in _identities(6):
        assert port.classify_actor(actor) == ref.classify_actor(actor)
    for cls in range(-1, len(classes) + 1):
        assert port.class_name(cls) == ref.class_name(cls)
        for bound in (1, 2, 7, 24, 96, 1000):
            assert port.depth_for(cls, bound) == ref.depth_for(cls, bound)
    for _ in range(200):
        queued = [int(x) for x in rng.integers(0, len(classes),
                                               int(rng.integers(0, 9)))]
        inc = int(rng.integers(0, len(classes)))
        assert port.shed_victim(queued, inc) == ref.shed_victim(queued, inc)


def _signal_stream(seed: int, n: int = 500) -> list[dict]:
    """Seeded signal vectors, hot and cold mixed per plane, with a
    cumulative shed counter."""
    rng = np.random.default_rng(seed)
    sheds = 0.0
    out = []
    for _ in range(n):
        mode = int(rng.integers(0, 3))  # 0 cold, 1 middle, 2 hot
        queue = [0.0, 5.0, 40.0][mode] * float(rng.random())
        p95 = [2.0, 30.0, 120.0][mode] * float(rng.random())
        depth = [0.05, 0.3, 0.95][int(rng.integers(0, 3))] * float(
            rng.random())
        if rng.random() < 0.2:
            sheds += float(rng.integers(1, 5))
        out.append(_signals(queue=queue, p95=p95, depth=depth, sheds=sheds))
    return out


CONTROL_CONFIGS = [
    dict(),
    dict(cooldown_ticks=0, replicas_max=4, dealer_deals_max=8),
    dict(cooldown_ticks=2, serving_rows_init=8, serving_rows_min=8,
         serving_rows_max=256, queue_high=4, queue_low=1,
         latency_high_ms=12.5, latency_low_ms=2.5, ingest_capacity_init=24,
         ingest_capacity_min=24, replicas_init=2, replicas_max=2),
]


@pytest.mark.parametrize("kw", CONTROL_CONFIGS,
                         ids=["defaults", "no_cooldown", "drill"])
def test_control_policy_streams_equal_the_reference(kw):
    port = ControlPolicy(AutoscalerConfig(**kw))
    ref = jautoscaler.ControlPolicy(jautoscaler.AutoscalerConfig(**kw))
    ps, rs = port.initial_state(), ref.initial_state()
    assert ps == rs
    moves = 0
    for sig in _signal_stream(len(kw)):
        pd, ps = port.decide(dict(sig), ps)
        rd, rs = ref.decide(dict(sig), rs)
        assert pd == rd
        moves += len(pd)
    assert ps == rs
    assert moves > 20  # the stream moved the knobs, both ways


def test_ledgers_digest_equal_and_replay_across_packages():
    """The same scripted sensor through each package's ``tick_once``: the
    ledgers' digests are equal, and each replays under the other
    package's config and oracle."""
    kw = dict(cooldown_ticks=1)
    script = LEDGER_SCRIPT + _signal_stream(11, n=60)
    port = _scripted(Autoscaler, AutoscalerConfig(**kw), script,
                     ScalingLedger)
    from d4pg_tpu.elastic.ledger import ScalingLedger as JLedger

    ref = _scripted(jautoscaler.Autoscaler, jautoscaler.AutoscalerConfig(**kw),
                    script, JLedger)
    assert port.ledger.digest() == ref.ledger.digest()
    assert replay_matches(AutoscalerConfig(**kw), ref.ledger)
    assert jautoscaler.replay_matches(jautoscaler.AutoscalerConfig(**kw),
                                      port.ledger)
    assert replay_decisions(AutoscalerConfig(**kw), ref.ledger.records()) \
        == [r["decisions"] for r in port.ledger.records()]
    assert port.ledger.to_jsonable(tail=3)["digest"] == ref.ledger.digest()


# --- the port's planes under the policy ---------------------------------------

OBS, ACT = 3, 2


def _batch(rows: int, tag: float = 0.0) -> TransitionBatch:
    return TransitionBatch(
        obs=np.full((rows, OBS), tag, np.float32),
        action=np.zeros((rows, ACT), np.float32),
        reward=np.zeros(rows, np.float32),
        next_obs=np.zeros((rows, OBS), np.float32),
        done=np.zeros(rows, np.float32),
        discount=np.ones(rows, np.float32))


class _GatedBuffer(ReplayBuffer):
    """A host ring whose ``add`` waits for ``gate``: the commit thread
    stalls, so the shard deques back up as under a slow commit."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.gate = threading.Event()

    def add(self, batch):
        assert self.gate.wait(timeout=30.0)
        return super().add(batch)


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline
        time.sleep(0.005)


def test_admission_sheds_the_lowest_class_first_over_two_shards():
    """Two shards at a watermark of 2, the commit stalled: a bulk batch
    is shed before an rt one (oldest first within the class), an incoming
    bulk batch below a queue of rt is itself rejected, and every shed row
    is attributed to its class, summed over the shards."""
    buf = _GatedBuffer(256, OBS, ACT, seed=0)
    svc = ReplayService(buf, ingest_capacity=4, shed_watermark=0.5,
                        num_ingest_shards=2, admission=AdmissionPolicy())
    try:
        # one batch reaches the stalled commit, one waits in each shard's
        # slot of the merge's inbox; both deques are empty again
        for shard in (0, 0, 1):
            assert svc.add(_batch(1), actor_id="actor-0", shard=shard)
            _wait(lambda: svc.ingest_stats()["per_shard"][shard]
                  ["queue_depth"] == 0)
        # shard 0: bulk then rt queued, an rt arrival evicts the bulk one
        assert svc.add(_batch(3), actor_id="actor-1", shard=0)   # bulk
        assert svc.add(_batch(5), actor_id="actor-0", shard=0)   # rt
        assert svc.add(_batch(7), actor_id="actor-2", shard=0)   # rt
        # shard 1: two rt queued, a bulk arrival is rejected itself
        assert svc.add(_batch(2), actor_id="actor-4", shard=1)
        assert svc.add(_batch(4), actor_id="proc-6", shard=1)
        assert not svc.add(_batch(6), actor_id="actor-9", shard=1)
        stats = svc.ingest_stats()
        per = stats["per_shard"]
        assert per[0]["sheds_by_class"] == {"bulk": 3}
        assert per[1]["sheds_by_class"] == {"bulk": 6}
        assert stats["sheds_by_class"] == {"bulk": 9}
        assert (stats["sheds"], stats["shed_rows"]) == (1, 3)
        assert stats["admit_fails"] == 1
        assert [e for e in FLIGHT.events()
                if e["kind"] == "admission_reject"][-1]["cls"] == "bulk"
        buf.gate.set()
        svc.flush(timeout=10.0)
        stats = svc.ingest_stats()
        assert stats["pending"] == 0
        # 3 + 5 + 7 + 2 + 4 rows committed, the shed and rejected ones not
        assert stats["rows_committed"] == 3 + 5 + 7 + 2 + 4
    finally:
        buf.gate.set()
        svc.close()


def test_flat_shedding_without_a_policy_is_oldest_first():
    buf = _GatedBuffer(256, OBS, ACT, seed=0)
    svc = ReplayService(buf, ingest_capacity=4, shed_watermark=0.5)
    try:
        for i in range(2):
            assert svc.add(_batch(1), actor_id="actor-0")
            _wait(lambda: svc.ingest_stats()["queue_depth"] == 0)
        for rows, actor in ((3, "actor-0"), (5, "actor-1"), (7, "actor-1")):
            assert svc.add(_batch(rows), actor_id=actor)
        stats = svc.ingest_stats()
        assert (stats["sheds"], stats["shed_rows"]) == (1, 3)
        assert stats["sheds_by_class"] == {}
    finally:
        buf.gate.set()
        svc.close()


def test_set_ingest_depth_wakes_a_blocked_producer():
    """A producer blocked on a full deque (no watermark, the commit
    stalled) returns within 1 s of a resize upward, admitted."""
    buf = _GatedBuffer(256, OBS, ACT, seed=0)
    svc = ReplayService(buf, ingest_capacity=1)
    try:
        for i in range(2):
            assert svc.add(_batch(1), actor_id="actor-0")
            _wait(lambda: svc.ingest_stats()["queue_depth"] == 0)
        assert svc.add(_batch(1), actor_id="actor-0")  # fills the deque
        result = {}

        def produce():
            result["ok"] = svc.add(_batch(1), actor_id="actor-0",
                                   timeout=20.0)
            result["t"] = time.monotonic()

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        time.sleep(0.3)
        assert t.is_alive()  # blocked on the full deque
        t0 = time.monotonic()
        svc.set_ingest_depth(4)
        t.join(timeout=1.0)
        assert not t.is_alive() and result["ok"]
        assert result["t"] - t0 < 1.0
        assert svc.ingest_stats()["ingest_capacity"] == 4
        buf.gate.set()
        svc.flush(timeout=10.0)
        assert svc.ingest_stats()["rows_committed"] == 4
    finally:
        buf.gate.set()
        svc.close()


NET = dict(obs_dim=4, act_dim=2, v_min=-50.0, v_max=0.0, n_atoms=11,
           hidden=(32, 32))
CFG = tstate.D4PGConfig(**NET)


def _server(**kw):
    store = WeightStore()
    store.publish(tstate.init_state(CFG, 0, "cpu").actor, step=1)
    server = PolicyInferenceServer(CFG, store, **kw)
    _wait(lambda: server.serving_stats()["version"] > 0)
    return server


def _client(server, lane):
    return RemotePolicyClient(CFG, ActorConfig(), "127.0.0.1", server.port,
                              lane_id=lane, seed=lane, timeout=20.0)


def _in_thread(fn):
    out = {}

    def run():
        out["v"] = fn()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


def test_server_admission_answers_overload_to_the_low_class():
    """``admission_depth=2``: with one request pending (a long window),
    a bulk lane's request is over its budget of 1 and is answered
    ``STATUS_OVERLOAD`` at once (the client counts it), an rt lane's is
    admitted; after ``set_admission_depth(6)`` a bulk request is
    admitted too, and a shorter window closes the open one. Every reject is attributed to its class."""
    server = _server(batch_window_s=30.0, max_batch_rows=64,
                     admission=AdmissionPolicy(), admission_depth=2)
    clients = [_client(server, lane) for lane in range(4)]
    obs = np.zeros((2, 4), np.float32)
    try:
        first, got_first = _in_thread(lambda: clients[1].greedy_actions(obs))
        _wait(lambda: server.serving_stats()["queue_depth"] == 1)
        t0 = time.monotonic()
        acts = clients[3].actions(obs)  # bulk: rejected, warm-up fallback
        assert time.monotonic() - t0 < 5.0 and acts.shape == (2, 2)
        st = clients[3].stats()
        assert st["overload_rejected"] == 1 and st["served"] == 0
        rt, got_rt = _in_thread(lambda: clients[0].greedy_actions(obs))
        _wait(lambda: server.serving_stats()["queue_depth"] == 2)
        server.set_admission_depth(6)  # the bulk budget is 3 now
        bulk, got_bulk = _in_thread(lambda: clients[3].greedy_actions(obs))
        _wait(lambda: server.serving_stats()["queue_depth"] == 3)
        stats = server.serving_stats()
        assert stats["admission_rejects"] == 1
        assert stats["admission_rejects_by_class"] == {"bulk": 1}
        assert stats["admission_depth"] == 6
        server.set_batch_limits(window_s=0.001)  # the open window closes
        for t in (first, rt, bulk):
            t.join(timeout=10.0)
            assert not t.is_alive()
        assert all(out["v"].shape == (2, 2)
                   for out in (got_first, got_rt, got_bulk))
        assert clients[3].stats()["served"] == 1
        assert [e for e in FLIGHT.events() if e["kind"] == "admission_reject"
                and e.get("plane") == "serving"]
    finally:
        for c in clients:
            c.close()
        server.close()


def test_set_batch_limits_take_effect_for_the_next_window():
    """A request pending in a 30-s window is served at once when the row
    budget drops below its rows (the open window closes under the new
    limits); the next windows run at the new window length, and a
    ``sla_latency_ms`` of 0 counts every served request as a breach."""
    server = _server(batch_window_s=30.0, max_batch_rows=64,
                     sla_latency_ms=0.0)
    client = _client(server, 0)
    obs = np.zeros((3, 4), np.float32)
    try:
        t, got = _in_thread(lambda: client.greedy_actions(obs))
        _wait(lambda: server.serving_stats()["queue_depth"] == 1)
        t0 = time.monotonic()
        server.set_batch_limits(max_rows=2)
        t.join(timeout=10.0)
        assert not t.is_alive() and time.monotonic() - t0 < 5.0
        stats = server.serving_stats()
        assert (stats["max_batch_rows"], stats["batch_window_s"]) == (2, 30.0)
        server.set_batch_limits(window_s=0.002, max_rows=64)
        t0 = time.monotonic()
        for _ in range(3):
            assert client.greedy_actions(obs).shape == (3, 2)
        assert time.monotonic() - t0 < 10.0
        # the batcher counts a batch after it writes its responses
        _wait(lambda: server.serving_stats()["responses_ok"] == 4)
        stats = server.serving_stats()
        assert (stats["max_batch_rows"], stats["batch_window_s"]) == (64,
                                                                      0.002)
        assert stats["responses_ok"] == 4 and stats["latency_breaches"] == 4
        assert client.stats()["fallbacks"] == 0
    finally:
        client.close()
        server.close()


# --- the driver --------------------------------------------------------------

TINY = dict(env="point", max_steps=20, num_envs=2, warmup=100, n_epochs=1,
            n_cycles=3, episodes_per_cycle=1, train_steps_per_cycle=6,
            updates_per_dispatch=4, eval_trials=1, batch_size=16,
            memory_size=2000, hidden=(16, 16), n_atoms=11, v_min=-5.0,
            v_max=0.0, platform="cpu", fused_replay="off",
            sample_on_ingest=True, learners=2)
TINY_ARGV = ["--env", "point", "--max_steps", "20", "--num_envs", "2",
             "--warmup", "100", "--n_eps", "1", "--n_cycles", "3",
             "--episodes_per_cycle", "1", "--train_steps_per_cycle", "6",
             "--updates_per_dispatch", "4", "--eval_trials", "1",
             "--bsize", "16", "--rmsize", "2000", "--n_atoms", "11",
             "--v_min", "-5", "--v_max", "0", "--platform", "cpu"]


def _capture_elastic(monkeypatch, on_plane=None):
    seen = {}
    plane = ttrain.elastic_plane

    def capture(cfg, service, policy_server, replicas, target):
        scaler = plane(cfg, service, policy_server, replicas, target)
        seen.update(scaler=scaler, service=service, server=policy_server,
                    replicas=replicas, target=target)
        if on_plane is not None:
            on_plane(seen)
        return scaler

    monkeypatch.setattr(ttrain, "elastic_plane", capture)
    return seen


def test_autoscale_driver_wires_every_knob(tmp_path, monkeypatch, capsys):
    """``--autoscale 1`` with the dealt plane, two learners and the policy
    server, a policy lane querying the server meanwhile: the banner names
    the five knobs, a tick sensed a non-zero signal, the ledger replays,
    every knob read back from its owner equals the ledger's last target,
    no lock violation, a finite loss."""
    stop = threading.Event()
    lane_state = {"served": 0}

    def start_lane(seen):
        server = seen["server"]
        client = _lane_client(server)

        def lane():
            obs = np.zeros((4, 4), np.float32)
            while not stop.is_set():
                client.actions(obs)  # warm-up actions until it adopts
                lane_state["served"] = client.stats()["served"]
            client.close()

        seen["lane"] = threading.Thread(target=lane, daemon=True)
        seen["lane"].start()
        scaler = seen["scaler"]
        _wait(lambda: lane_state["served"] > 0, timeout=30.0)
        ticks = scaler.autoscaler_stats()["ticks"]
        _wait(lambda: scaler.autoscaler_stats()["ticks"] > ticks + 1,
              timeout=30.0)
        close = scaler.close

        def closing():
            stop.set()
            seen["lane"].join(timeout=30.0)
            close()

        scaler.close = closing

    seen = _capture_elastic(monkeypatch, start_lane)
    violations = locking.violation_count()
    crashes = REGISTRY.counter("threads.contained_crashes").value
    with locking.record_mode():  # every acquisition of the run checked
        metrics = ttrain.main([
            *TINY_ARGV, "--log_dir", str(tmp_path), "--fused_replay", "off",
            "--sample_on_ingest", "1", "--sampler", "pallas",
            "--learners", "2", "--serve", "1", "--serve_policy", "1",
            "--autoscale", "1", "--autoscale_interval_s", "0.02"])
    assert np.isfinite(metrics["critic_loss"])
    out = capsys.readouterr().out
    assert ("elastic: autoscaler up, knobs=['dealer_deals', "
            "'ingest_capacity', 'replicas', 'serving_rows', "
            "'serving_window_s']") in out
    scaler = seen["scaler"]
    assert not seen["lane"].is_alive() and lane_state["served"] > 0
    records = scaler.ledger.records()
    assert any(any(v != 0.0 for v in r["signals"].values())
               for r in records)
    assert all(type(v) is float for r in records
               for v in r["signals"].values())
    json.dumps(records)  # plain Python values throughout
    assert replay_matches(scaler.cfg, scaler.ledger)
    last = records[-1]["targets"]
    sstats = seen["server"].serving_stats()
    assert sstats["max_batch_rows"] == last["serving_rows"]
    assert sstats["batch_window_s"] == last["serving_window_s"]
    assert seen["service"].ingest_stats()["ingest_capacity"] == \
        last["ingest_capacity"]
    assert seen["service"].dealer.max_deals_per_tick == last["dealer_deals"]
    assert seen["target"].n == last["replicas"]
    assert scaler.stats["actuator_errors"] == 0
    assert locking.violation_count() == violations
    assert REGISTRY.counter("threads.contained_crashes").value == crashes
    assert "elastic" not in REGISTRY.export()


def _lane_client(server):
    return RemotePolicyClient(CFG_DRIVER, ActorConfig(), "127.0.0.1",
                              server.port, lane_id=1, seed=1, timeout=20.0)


CFG_DRIVER = tstate.D4PGConfig(obs_dim=4, act_dim=2, v_min=-5.0, v_max=0.0,
                               n_atoms=11, hidden=(16, 16))


COLD = {}
HOT = {"serving": {"queue_depth": 99, "latency_ms": {"p95": 500.0}},
       "ingest": {"sheds": 0, "per_shard": [{"queue_depth": 9,
                                             "capacity": 10}]}}


def test_parked_replica_respawns_once_and_its_old_submission_bounces(
        tmp_path, monkeypatch):
    """A scripted sensor drives ``replicas`` 2 -> 1 (one cold tick before
    cycle 2) -> 2 (four hot ticks before cycle 3: the cooldown): replica 1
    sits cycle 2 out and calls ``respawn`` once as it comes back, and the
    submission it sent in cycle 1 bounces at the aggregator as fenced."""
    from d4pg_tpu_torch.elastic import autoscaler as tautoscaler
    from d4pg_tpu_torch.learner.aggregator import Aggregator
    from d4pg_tpu_torch.learner.replica import LearnerReplica

    monkeypatch.setattr(tautoscaler.Autoscaler, "start", lambda self: self)
    seen = _capture_elastic(monkeypatch)
    cycles = {"n": 0}
    script = {1: [COLD], 2: [HOT] * 4}
    activate = ttrain.ReplicaTarget.activate

    def scripted_activate(target, replicas):
        for snapshot in script.get(cycles["n"], []):
            seen["scaler"]._sensor = lambda s=snapshot: s
            seen["scaler"].tick_once()
        cycles["n"] += 1
        active = activate(target, replicas)
        seen.setdefault("active", []).append(
            [r.replica_id for r in active])
        return active

    respawns = []
    respawn = LearnerReplica.respawn

    def counted_respawn(replica):
        respawns.append(replica.replica_id)
        return respawn(replica)

    submits = []
    submit = Aggregator.submit

    def recorded_submit(agg, replica_id, epoch, params, basis_version,
                        step=0, generation=None):
        out = submit(agg, replica_id, epoch, params, basis_version,
                     step=step, generation=generation)
        submits.append((agg, replica_id, epoch, params, basis_version,
                        out["status"]))
        return out

    monkeypatch.setattr(ttrain.ReplicaTarget, "activate", scripted_activate)
    monkeypatch.setattr(LearnerReplica, "respawn", counted_respawn)
    monkeypatch.setattr(Aggregator, "submit", recorded_submit)
    cfg = ExperimentConfig(**{**TINY, "log_dir": str(tmp_path),
                              "sampler": "host", "autoscale": True})
    metrics = ttrain.train(cfg)
    assert np.isfinite(metrics["critic_loss"])
    assert seen["active"] == [[0, 1], [0], [0, 1]]
    assert respawns == [1]
    assert [r["decisions"].get("replicas") for r in
            seen["scaler"].ledger.records()] == [1, None, None, None, 2]
    assert replay_matches(seen["scaler"].cfg, seen["scaler"].ledger)
    # replica 1's cycle-1 submission, landing after the park: fenced
    agg, rid, epoch, params, basis, status = next(
        s for s in submits if s[1] == 1)
    assert status == "applied"
    late = submit(agg, rid, epoch, params, basis)
    assert late["status"] == "fenced"
    # the respawned epoch trained and was applied in cycle 3
    assert [s[5] for s in submits if s[1] == 1] == ["applied", "applied"]


# --- the elastic drill ----------------------------------------------------------

DRILL = dict(device="cpu", model_horizon_s=0.5, flash_start_s=0.15,
             flash_duration_s=0.2, n_lanes=4, n_ingest_lanes=2)


def _keys(block) -> object:
    """The nested key structure of a report block (dicts only; lists,
    values and free-form class tables as leaves)."""
    if not isinstance(block, dict):
        return None
    return {k: _keys(v) for k, v in block.items()}


@pytest.fixture(scope="module")
def drills():
    from d4pg_tpu_torch.fleet import run_elastic_chaos

    return run_elastic_chaos(**DRILL), run_elastic_chaos(**DRILL)


def test_drill_report_has_the_reference_artifact_schema(drills):
    """The drill block's keys are the committed reference artifact's
    (``docs/evidence/elastic/``), read as data, plus the draw-ledger keys
    the reference's drill writes since (``draw_ledger`` per arm,
    ``draw_digest_equal`` in the gate)."""
    (art_path,) = sorted(glob.glob(os.path.join(
        ROOT, "docs", "evidence", "elastic", "elastic_*.json")))[-1:]
    with open(art_path) as f:
        drill = json.load(f)["drill"]
    report, _ = drills
    assert set(report) == set(drill)
    assert report["metric"] == drill["metric"] == "elastic_chaos"
    assert set(report["ab_gate"]) == set(drill["ab_gate"]) | {
        "draw_digest_equal"}
    assert set(report["trace"]) == set(drill["trace"])
    assert set(report["flash"]) == set(drill["flash"])
    for arm in ("static", "elastic"):
        want, got = drill["arms"][arm], report["arms"][arm]
        assert set(got) == set(want) | {"draw_ledger"}
        for block in ("requests", "request_latency_ms", "serving", "ingest"):
            assert set(got[block]) == set(want[block]), (arm, block)
        assert len(got["curves"]) == len(want["curves"])
        assert all(set(g) == set(w)
                   for g, w in zip(got["curves"], want["curves"]))
    assert set(report["arms"]["elastic"]["autoscaler"]) == set(
        drill["arms"]["elastic"]["autoscaler"])
    assert "autoscaler" not in report["arms"]["static"]


def test_drill_oracles_hold(drills):
    for report in drills:
        gate = report["ab_gate"]
        assert gate["draw_digest_equal"] is True
        assert report["hierarchy_violations"] == 0
        assert report["contained_crashes"] == 0
        assert report["trace"]["orphans"] == 0
        scaler = report["arms"]["elastic"]["autoscaler"]
        assert scaler["ledger_replay_ok"] is True
        assert scaler["ticks"] > 0 and scaler["actuator_errors"] == 0
        for arm in report["arms"].values():
            assert arm["requests"]["sent"] > 0
            assert arm["requests"]["errors"] == 0
            ing, srv = arm["ingest"], arm["serving"]
            # every shed and reject is attributed to a class
            assert sum(ing["sheds_by_class"].values()) >= ing["shed_rows"]
            assert sum(srv["admission_rejects_by_class"].values()) == \
                srv["admission_rejects"]


def test_drill_draw_ledgers_replay_at_one_seed(drills):
    a, b = drills
    for arm in ("static", "elastic"):
        assert a["arms"][arm]["draw_ledger"]["digest"] == \
            b["arms"][arm]["draw_ledger"]["digest"]
        assert a["arms"][arm]["draw_ledger"] == b["arms"][arm]["draw_ledger"]
    # both arms offer the same seeded load: the same request schedule
    for report in drills:
        assert report["arms"]["static"]["requests"]["sent"] == \
            report["arms"]["elastic"]["requests"]["sent"]
        assert report["arms"]["static"]["ingest"]["blocks_offered"] == \
            report["arms"]["elastic"]["ingest"]["blocks_offered"]
