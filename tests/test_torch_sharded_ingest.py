"""Port vs reference: the sharded ingest plane (``ReplayService`` with K
ingest shards, ``staging.MultiRingStaging``, ``FusedDeviceReplay(
ingest_shards=K)``, the sharded ``TransitionReceiver``).

Bitwise, on the CPU: the K = 2 direct stage (shard workers pushing into
their own staging rings without the buffer lock) lands the ring, both
PER trees and the ``ingest_stats`` row ledger of the port's K = 1 service
and of the reference's K = 2 service; the multi-ring merge lands the
bytes of one ring and of the per-row drain; K = 2 with a normalizer
keeps K = 1's rows and statistics; rows pushed into a shard ring while a
block is in flight land as staged. Then the reference's
``tests/test_transport_faults.py`` cases against the port: the shed
watermark (per shard at K = 2, counted, never blocking), blocking
admission without one, eviction and re-admission, a decode error
tombstoned, a stale ticket below the merge floor dropped, the
order-break valve, a corrupt v2 frame dropping its connection without a
thread crash; the sharded receiver with raw and npz frames, its
round-robin fallback without ``SO_REUSEPORT``, the wire spans of a traced
frame and the generation fence; a stress run of the direct stage under
contention, and the staging's ticket floor across a snapshot. Every
socket wait has a deadline and every service and receiver closes in a
``finally``.
"""

import itertools
import socket
import sys
import threading
import time

import numpy as np
import pytest

from d4pg_tpu.distributed.replay_service import ReplayService as JaxService
from d4pg_tpu.replay.fused_buffer import FusedDeviceReplay as JaxFused
from d4pg_tpu.replay.uniform import TransitionBatch as JaxBatch
from d4pg_tpu_torch.distributed import replay_service as rs
from d4pg_tpu_torch.distributed import transport as tt
from d4pg_tpu_torch.distributed.replay_service import ReplayService
from d4pg_tpu_torch.envs.normalizer import RunningMeanStd
from d4pg_tpu_torch.obs.registry import REGISTRY
from d4pg_tpu_torch.obs.trace import RECORDER
from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
from d4pg_tpu_torch.replay.uniform import ReplayBuffer, TransitionBatch

pytestmark = pytest.mark.torchport

OBS, ACT = 5, 2
SIZES = (8, 3, 16, 5, 12, 7, 9, 4)


def _rows(rng, n, obs=OBS, act=ACT) -> dict:
    done = (rng.random(n) < 0.2).astype(np.float32)
    return dict(
        obs=rng.standard_normal((n, obs)).astype(np.float32),
        action=rng.uniform(-1, 1, (n, act)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.standard_normal((n, obs)).astype(np.float32),
        done=done, discount=(0.99 * (1 - done)).astype(np.float32))


def _batch(n=8, seed=0, obs=4, act=2) -> TransitionBatch:
    return TransitionBatch(**_rows(np.random.default_rng(seed), n, obs, act))


def _same_ring(a, b, rows: int) -> None:
    """Two fused buffers (either package) hold the same rows and trees."""
    assert (a.size, a.head) == (b.size, b.head)
    for name, x, y in zip(TransitionBatch._fields, a.storage, b.storage):
        np.testing.assert_array_equal(np.asarray(x)[:rows],
                                      np.asarray(y)[:rows], err_msg=name)
    for x, y in zip(a.trees, b.trees):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _ledger(stats: dict) -> tuple:
    return (stats["rows_committed"], stats["env_steps"],
            sum(p["rows_in"] for p in stats["per_shard"]))


# ------------------------------------------------------ bitwise staging ----

@pytest.mark.parametrize("prioritized", [True, False])
def test_multi_ring_merge_equals_one_ring_and_the_per_row_drain(rng,
                                                                prioritized):
    """K private rings and the ticket-ordered merge land the bytes and
    priorities of one ring and of the per-row drain, over rounds that
    wrap the ring."""
    kw = dict(block_rows=32, prioritized=prioritized, device="cpu")
    one = FusedDeviceReplay(96, OBS, ACT, **kw)
    two = FusedDeviceReplay(96, OBS, ACT, ingest_shards=2, **kw)
    per_row = FusedDeviceReplay(96, OBS, ACT, ingest_shards=2, **kw)
    for rnd in range(4):
        for t, n in enumerate((13, 24, 7, 30, 9)):
            batch = TransitionBatch(**_rows(rng, n))
            one.add(batch)
            two.add_sharded(batch, shard=t % 2, ticket=rnd * 10 + t)
            per_row.add_sharded(batch, shard=t % 2, ticket=rnd * 10 + t)
        assert one.drain() == two.drain() == per_row.drain_per_row() == 83
        for a, b in ((one, two), (two, per_row)):
            assert (a.size, a.head) == (b.size, b.head)
            for x, y in zip(a.storage, b.storage):
                np.testing.assert_array_equal(x[:96].numpy(), y[:96].numpy())
            if prioritized:
                for x, y in zip(a.trees, b.trees):
                    np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_merge_orders_by_ticket_not_by_shard(rng):
    """Pushed out of ticket order across shards, the rows still land in
    ticket order."""
    buf = FusedDeviceReplay(64, OBS, ACT, block_rows=8, ingest_shards=2,
                            device="cpu")
    parts = [_rows(rng, n) for n in (3, 5, 4)]
    buf.add_sharded(TransitionBatch(**parts[1]), shard=1, ticket=1)
    buf.add_sharded(TransitionBatch(**parts[0]), shard=0, ticket=0)
    buf.add_sharded(TransitionBatch(**parts[2]), shard=0, ticket=2)
    assert len(buf) == 12
    assert buf.drain() == 12
    want = np.concatenate([p["obs"] for p in parts])
    np.testing.assert_array_equal(buf.storage.obs[:12].numpy(), want)


def test_shard_ring_overflow_trims_its_oldest_records(rng):
    """A shard ring that laps drops its oldest rows and the same rows off
    its records: the merge still lands the newest ring-full in order."""
    buf = FusedDeviceReplay(64, OBS, ACT, block_rows=4, staging_blocks=2,
                            ingest_shards=2, device="cpu")
    parts = [_rows(rng, 3) for _ in range(4)]  # 12 rows into an 8-row ring
    for t, p in enumerate(parts):
        buf.add_sharded(TransitionBatch(**p), shard=0, ticket=t)
    assert buf.drain() == 8
    want = np.concatenate([p["obs"] for p in parts])[-8:]
    np.testing.assert_array_equal(buf.storage.obs[:8].numpy(), want)


def test_pushes_while_a_block_is_in_flight_land_as_staged_at_k2(rng):
    """Phase 10's scenario at two shards: rows pushed into the shard
    rings while a block is in flight lap them (shard 0's overwrite the
    rows the block was read from, shard 1's drop its oldest) and leave
    the ring and trees of synchronous drains."""
    kw = dict(block_rows=8, staging_blocks=2, ingest_shards=2, device="cpu")
    inflight, synchronous = (FusedDeviceReplay(64, OBS, ACT, **kw),
                             FusedDeviceReplay(64, OBS, ACT, **kw))
    first = _rows(rng, 8)
    late = [_rows(rng, 6) for _ in range(5)]
    inflight.add_sharded(TransitionBatch(**first), shard=0, ticket=0)
    assert inflight.stage_block() == 8
    for t, rows in enumerate(late, start=1):
        inflight.add_sharded(TransitionBatch(**rows), shard=t % 2, ticket=t)
    assert inflight.commit_staged() == 8
    assert inflight.drain() == 28  # shard 1's ring keeps its newest 16
    synchronous.add_sharded(TransitionBatch(**first), shard=0, ticket=0)
    synchronous.drain()
    for t, rows in enumerate(late, start=1):
        synchronous.add_sharded(TransitionBatch(**rows), shard=t % 2,
                                ticket=t)
    synchronous.drain()
    _same_ring(inflight, synchronous, 64)
    np.testing.assert_array_equal(inflight.storage.obs[:8].numpy(),
                                  first["obs"])


def test_service_direct_stage_k2_bitwise_equals_k1_and_reference(rng):
    """Through the services: the port's K = 2 service over a sharded
    fused buffer takes the direct stage and lands the ring, both trees and
    the row ledger of the port's K = 1 service and of the reference's
    K = 2 service."""
    admitted0 = REGISTRY.counter("ingest.rows_admitted").value
    committed0 = REGISTRY.counter("ingest.rows_committed").value
    f1 = FusedDeviceReplay(256, OBS, ACT, block_rows=32, device="cpu")
    f2 = FusedDeviceReplay(256, OBS, ACT, block_rows=32, ingest_shards=2,
                           device="cpu")
    jf = JaxFused(256, OBS, ACT, block_rows=32, ingest_shards=2)
    s1, s2 = ReplayService(f1), ReplayService(f2, num_ingest_shards=2)
    js = JaxService(jf, num_ingest_shards=2)
    try:
        assert s2._direct_stage and js._direct_stage and not s1._direct_stage
        batches = [_rows(rng, n) for n in SIZES]
        for i, b in enumerate(batches):
            s1.add(TransitionBatch(**b))
            s2.add(TransitionBatch(**b), shard=i % 2)
            js.add(JaxBatch(**b), shard=i % 2)
        for s in (s1, s2, js):
            s.flush()
        assert s1.drain_device() == s2.drain_device() \
            == js.drain_device() == 64
        _same_ring(f1, f2, 64)
        _same_ring(f2, jf, 64)
        st1, st2, jst = s1.ingest_stats(), s2.ingest_stats(), js.ingest_stats()
        assert _ledger(st1) == _ledger(st2) == _ledger(jst) == (64, 64, 64)
        assert [p["rows_in"] for p in st2["per_shard"]] == \
            [p["rows_in"] for p in jst["per_shard"]]
        assert sum(p["staged_rows"] for p in st2["per_shard"]) == 64
        assert sum(p["staged_rows"] for p in st1["per_shard"]) == 0
        # the registry counts every row once, admitted and committed
        assert REGISTRY.counter("ingest.rows_admitted").value \
            - admitted0 == 128
        assert REGISTRY.counter("ingest.rows_committed").value \
            - committed0 == 128
    finally:
        for s in (s1, s2, js):
            s.close()


@pytest.mark.parametrize("kind", ["host", "fused"])
def test_k2_with_a_normalizer_keeps_k1_rows_and_statistics(rng, kind):
    """With a normalizer there is no direct stage: the commit thread folds
    and inserts in ticket order, so K = 2's rows and statistics are
    K = 1's, bitwise."""
    def buffer(shards):
        if kind == "host":
            return ReplayBuffer(500, OBS, ACT, device="cpu")
        return FusedDeviceReplay(256, OBS, ACT, block_rows=32,
                                 ingest_shards=shards, device="cpu")

    b1, b2 = buffer(1), buffer(2)
    n1, n2 = RunningMeanStd(OBS), RunningMeanStd(OBS)
    s1 = ReplayService(b1, obs_norm=n1)
    s2 = ReplayService(b2, obs_norm=n2, num_ingest_shards=2)
    try:
        assert not s2._direct_stage
        batches = [_rows(rng, n) for n in SIZES]
        for i, b in enumerate(batches):
            s1.add(TransitionBatch(**b))
            s2.add(TransitionBatch(**b), shard=i % 2)
            s1.flush()  # one batch at a time: ticket order is add order
            s2.flush()
        if kind == "host":
            rows1, rows2 = b1.gather(np.arange(64)), b2.gather(np.arange(64))
        else:
            assert s1.drain_device() == s2.drain_device() == 64
            rows1 = [t[:64].numpy() for t in b1.storage]
            rows2 = [t[:64].numpy() for t in b2.storage]
        for name, x, y in zip(TransitionBatch._fields, rows1, rows2):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=name)
        d1, d2 = n1.state_dict(), n2.state_dict()
        for k in d1:
            np.testing.assert_array_equal(d1[k], d2[k], err_msg=k)
    finally:
        s1.close()
        s2.close()


def test_direct_stage_under_contention_loses_no_row():
    """More producer threads than cores and a short switch interval at
    K = 2 with a small admission deque, while the learner's thread stages
    and commits blocks the whole time: every row lands exactly once, and
    the ledger agrees."""
    producers, batches, rows = 16, 12, 5
    total = producers * batches * rows
    buf = FusedDeviceReplay(total, OBS, ACT, block_rows=64,
                            staging_blocks=16, ingest_shards=2, device="cpu")
    svc = ReplayService(buf, ingest_capacity=4, num_ingest_shards=2)
    done = threading.Event()

    def produce(p):
        for b in range(batches):
            ids = (p * batches + b) * rows + np.arange(rows)
            obs = np.repeat(ids[:, None], OBS, 1).astype(np.float32)
            assert svc.add(TransitionBatch(
                obs=obs, action=np.zeros((rows, ACT), np.float32),
                reward=np.zeros(rows, np.float32), next_obs=obs,
                done=np.zeros(rows, np.float32),
                discount=np.ones(rows, np.float32)),
                actor_id=f"p{p}", timeout=30.0, shard=p % 2)

    def learn():
        while not done.is_set():
            svc.ingest_commit()
            svc.ingest_stage()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    learner = threading.Thread(target=learn)
    try:
        learner.start()
        threads = [threading.Thread(target=produce, args=(p,))
                   for p in range(producers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        svc.flush(timeout=30)
    finally:
        done.set()
        learner.join(timeout=30)
        sys.setswitchinterval(interval)
    try:
        assert not learner.is_alive()
        svc.drain_device()
        assert svc.env_steps == total and buf.size == total
        ids = np.sort(buf.storage.obs[:total, 0].numpy())
        np.testing.assert_array_equal(ids, np.arange(total))
        stats = svc.ingest_stats()
        assert stats["pending"] == 0 and stats["rows_committed"] == total
        assert sum(p["staged_rows"] for p in stats["per_shard"]) == total
        assert stats["admit_fails"] == stats["order_breaks"] == 0
    finally:
        svc.close()


def test_staging_ticket_floor_survives_snapshot_and_restore(rng):
    """``MultiRingStaging.snapshot`` records the ticket floor of a drained
    cut; a fresh staging restored from it orders its own pushes after
    every ticket before the cut."""
    from d4pg_tpu_torch.replay.staging import MultiRingStaging
    from d4pg_tpu_torch.replay.uniform import field_layouts

    specs = field_layouts(OBS, ACT)
    old = MultiRingStaging(specs, 8, 2, 2)
    for shard in (0, 1, 0):
        old.push(TransitionBatch(**_rows(rng, 3)), shard=shard)
    while old.frame()[1]:
        old.pop(old.frame()[1])
    snap = old.snapshot()
    assert snap == {"ticket_floor": 3, "staged_rows": 0}
    new = MultiRingStaging(specs, 8, 2, 2)
    new.restore(snap)
    late = _rows(rng, 2)
    new.push(TransitionBatch(**late), shard=1)
    assert new._records[1][0] == (4, 2)
    frame, n = new.frame()
    assert n == 2
    np.testing.assert_array_equal(frame.obs, late["obs"])


def test_service_refuses_a_mismatched_sharded_buffer():
    buf = FusedDeviceReplay(32, OBS, ACT, ingest_shards=2, device="cpu")
    with pytest.raises(ValueError, match="ingest_shards"):
        ReplayService(buf, num_ingest_shards=3)


# ------------------------------------ tests/test_transport_faults.py ----

class _SlowBuffer:
    """A ``ReplayBuffer`` whose inserts take ``delay_s``: the shard deques
    back up, so shedding shows deterministically."""

    def __init__(self, inner, delay_s: float):
        self._inner = inner
        self._delay_s = delay_s
        self.inserted_batches = 0

    def add(self, batch):
        time.sleep(self._delay_s)
        self.inserted_batches += 1
        return self._inner.add(batch)

    def __len__(self):
        return len(self._inner)

    def __getattr__(self, name):
        return getattr(self._inner, name)


@pytest.mark.parametrize("shards", [1, 2])
def test_shed_watermark_drops_oldest_counted_never_blocks(shards):
    slow = _SlowBuffer(ReplayBuffer(10_000, 4, 2, device="cpu"), 0.05)
    svc = ReplayService(slow, ingest_capacity=4, shed_watermark=0.5,
                        num_ingest_shards=shards)
    try:
        t0 = time.monotonic()
        for i in range(12):
            assert svc.add(_batch(seed=i), actor_id=f"a{i % 2}",
                           block=False, shard=i % shards) is True
        assert time.monotonic() - t0 < 1.0  # never waited on an insert
        svc.flush(timeout=10.0)
        stats = svc.ingest_stats()
        assert stats["sheds"] > 0
        assert stats["shed_rows"] == 8 * stats["sheds"]
        # every accepted batch was inserted or counted shed
        assert slow.inserted_batches + stats["sheds"] == 12
        assert svc.env_steps == 8 * slow.inserted_batches
        assert stats["pending"] == 0 and stats["order_breaks"] == 0
        per = stats["per_shard"]
        assert len(per) == shards
        assert sum(p["sheds"] for p in per) == stats["sheds"]
        assert sum(p["rows_in"] for p in per) == 12 * 8
    finally:
        svc.close()


def test_without_a_watermark_a_full_shard_refuses_and_counts():
    slow = _SlowBuffer(ReplayBuffer(10_000, 4, 2, device="cpu"), 0.05)
    svc = ReplayService(slow, ingest_capacity=2)
    try:
        results = [svc.add(_batch(seed=i), actor_id="a0", block=False,
                           timeout=0.01) for i in range(10)]
        assert False in results  # backpressure surfaced, not absorbed
        stats = svc.ingest_stats()
        assert stats["sheds"] == 0
        assert stats["admit_fails"] == results.count(False)
        svc.flush(timeout=10.0)
    finally:
        svc.close()


def _payload(actor, seed, count=True, trace=None, generation=None):
    return tt.encode_raw(actor, _batch(seed=seed), count, trace=trace,
                         generation=generation)[tt._HEADER.size:]


def test_add_payload_without_watermark_blocks_not_drops():
    slow = _SlowBuffer(ReplayBuffer(10_000, 4, 2, device="cpu"), 0.01)
    svc = ReplayService(slow, ingest_capacity=2, num_ingest_shards=2)
    try:
        frames = [_payload(f"a{i % 2}", i) for i in range(16)]
        assert all(svc.add_payload(f, shard=i % 2, codec="raw")
                   for i, f in enumerate(frames))
        svc.flush(timeout=10.0)
        stats = svc.ingest_stats()
        assert svc.env_steps == 16 * 8  # every frame landed
        assert stats["sheds"] == stats["admit_fails"] == 0
        assert stats["pending"] == 0
    finally:
        svc.close()


@pytest.mark.parametrize("shards", [1, 2])
def test_evicted_actor_readmitted_on_heartbeat(shards):
    svc = ReplayService(ReplayBuffer(100, 4, 2, device="cpu"),
                        heartbeat_timeout=0.05, num_ingest_shards=shards)
    try:
        svc.heartbeat("a0")
        time.sleep(0.1)
        assert svc.dead_actors() == ["a0"]
        assert svc.evict_dead() == ["a0"]
        assert svc.evicted_actors() == ["a0"]
        assert svc.dead_actors() == ["a0"]  # evicted and silent: dead
        assert svc.evict_dead() == []  # idempotent
        svc.heartbeat("a0")
        assert svc.dead_actors() == [] and svc.evicted_actors() == []
        stats = svc.ingest_stats()
        assert stats["evictions"] == 1 and stats["readmissions"] == 1
        assert len(stats["recovery_s"]) == 1 and stats["recovery_s"][0] > 0
    finally:
        svc.close()


@pytest.mark.parametrize("shards", [1, 2])
def test_evicted_actor_readmitted_by_streaming(shards):
    """``add`` heartbeats: a restarted actor's first batch re-admits it,
    through another shard too."""
    svc = ReplayService(ReplayBuffer(100, 4, 2, device="cpu"),
                        heartbeat_timeout=0.05, num_ingest_shards=shards)
    try:
        svc.add(_batch(), actor_id="a1", shard=shards - 1)
        time.sleep(0.1)
        assert svc.evict_dead() == ["a1"]
        assert svc.dead_actors() == ["a1"]
        svc.add(_batch(), actor_id="a1", shard=0)
        assert svc.dead_actors() == []
        assert svc.ingest_stats()["readmissions"] == 1
        svc.flush()
        assert len(svc) == 16
    finally:
        svc.close()


def test_payload_decode_error_tombstoned_not_wedged():
    svc = ReplayService(ReplayBuffer(1000, 4, 2, device="cpu"),
                        num_ingest_shards=2, shed_watermark=0.9)
    try:
        good = _payload("a0", 0)
        corrupt = good[:-50]  # the header parses, the columns do not
        assert svc.add_payload(good, shard=0, codec="raw") is True
        assert svc.add_payload(corrupt, shard=1, codec="raw") is True
        assert svc.add_payload(good, shard=1, codec="raw") is True
        assert svc.add_payload(b"\xff" * 7, shard=0, codec="raw") is False
        svc.flush(timeout=10.0)
        stats = svc.ingest_stats()
        assert svc.env_steps == 16  # both good frames landed
        assert stats["decode_errors"] == 2  # one at the worker, one at
        assert stats["pending"] == 0       # admission
    finally:
        svc.close()


def test_stale_ticket_below_the_merge_floor_discarded_not_wedged():
    svc = ReplayService(ReplayBuffer(1000, 4, 2, device="cpu"),
                        num_ingest_shards=2)
    try:
        b = _batch()
        with svc._lock:
            svc._pending += 2
        with svc._commit_cond:
            svc._next_seq = 5  # the valve already advanced past ticket 3
            svc._seq = itertools.count(6)
            svc._out[0].append((3, "a0", b, 8, True, None))  # the late one
            svc._out[1].append((5, "a1", b, 8, True, None))  # the floor
            svc._commit_cond.notify_all()
        svc.flush(timeout=5.0)
        stats = svc.ingest_stats()
        assert stats["pending"] == 0 and stats["order_breaks"] >= 1
        assert svc.env_steps == 8 and len(svc) == 8
        with svc._commit_cond:
            assert not svc._out[0]
    finally:
        svc.close()


def test_order_break_valve_skips_a_lost_ticket_and_prunes_tombstones(
        monkeypatch):
    monkeypatch.setattr(rs, "_ORDER_GRACE_S", 0.2)
    svc = ReplayService(ReplayBuffer(1000, 4, 2, device="cpu"),
                        num_ingest_shards=2)
    try:
        b = _batch()
        with svc._lock:
            svc._pending += 1
        with svc._commit_cond:
            svc._skip.update({1, 2})  # tombstones below the coming jump
            svc._seq = itertools.count(8)
            svc._out[0].append((7, "a0", b, 8, True, None))  # 0-6 vanished
            svc._commit_cond.notify_all()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and svc.env_steps < 8:
            time.sleep(0.02)
        assert svc.env_steps == 8
        stats = svc.ingest_stats()
        assert stats["order_breaks"] >= 1 and stats["pending"] == 0
        with svc._commit_cond:
            assert not svc._skip
    finally:
        svc.close()


@pytest.mark.parametrize("shards", [1, 2])
def test_corrupt_v2_frame_drops_the_connection_without_a_thread_crash(
        shards):
    svc = ReplayService(ReplayBuffer(1000, 4, 2, device="cpu"),
                        num_ingest_shards=shards)
    crashes = []
    hook = threading.excepthook
    threading.excepthook = crashes.append
    recv = tt.TransitionReceiver(
        lambda b, aid, c: svc.add(b, actor_id=aid, count_env_steps=c),
        num_shards=shards,
        on_payload=svc.add_payload if shards > 1 else None)
    sender = None
    try:
        c = socket.create_connection(("127.0.0.1", recv.port), timeout=5.0)
        garbage = b"\xff" * 64
        c.sendall(tt._HEADER.pack(tt._MAGIC_RAW, len(garbage)) + garbage)
        if shards == 1:
            assert c.recv(1) == b""  # dropped at decode
        c.close()
        sender = tt.TransitionSender("127.0.0.1", recv.port, actor_id="ok",
                                     codec="raw", connect_timeout=5.0)
        assert sender.send(_batch()) is True
        assert svc.wait_until(8, timeout=10.0)
        assert not crashes
        if shards == 1:
            assert recv.frames_rejected == 1
        else:  # counted at admission, the connection kept
            deadline = time.monotonic() + 5.0
            while (svc.ingest_stats()["decode_errors"] < 1
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            assert svc.ingest_stats()["decode_errors"] == 1
    finally:
        threading.excepthook = hook
        if sender is not None:
            sender.close()
        recv.close()
        svc.close()


# -------------------------------------------------- the sharded receiver ----

@pytest.mark.parametrize("codec", ["raw", "npz"])
def test_sharded_receiver_forwards_undecoded_frames(codec):
    svc = ReplayService(ReplayBuffer(1000, 4, 2, device="cpu"),
                        num_ingest_shards=2)
    seen = []

    def on_payload(payload, shard, frame_codec):
        seen.append((shard, frame_codec))
        return svc.add_payload(payload, shard=shard, codec=frame_codec)

    recv = tt.TransitionReceiver(lambda *a: None, num_shards=2,
                                 on_payload=on_payload)
    senders = []
    try:
        assert recv.reuseport is True and recv.num_shards == 2
        senders = [tt.TransitionSender("127.0.0.1", recv.port,
                                       actor_id=f"a{i}", codec=codec,
                                       connect_timeout=5.0)
                   for i in range(4)]
        for i, s in enumerate(senders):
            assert s.send(_batch(seed=i), count_env_steps=i != 3)
        assert svc.wait_until(32, timeout=10.0)
        svc.flush()
        assert {c for _, c in seen} == {codec}
        assert {s for s, _ in seen} <= {0, 1}
        assert svc.env_steps == 24  # one frame's rows uncounted
        assert sorted(svc.rows_by_actor()) == ["a0", "a1", "a2", "a3"]
        stats = svc.ingest_stats()
        assert sum(p["rows_in"] for p in stats["per_shard"]) == 32
    finally:
        for s in senders:
            s.close()
        recv.close()
        svc.close()


def test_receiver_without_reuseport_assigns_shards_round_robin(monkeypatch):
    monkeypatch.delattr(socket, "SO_REUSEPORT", raising=False)
    seen = []
    got = threading.Event()

    def on_payload(payload, shard, codec):
        seen.append(shard)
        if len(seen) == 3:
            got.set()

    recv = tt.TransitionReceiver(lambda *a: None, num_shards=2,
                                 on_payload=on_payload)
    senders = []
    try:
        assert recv.reuseport is False and len(recv._servers) == 1
        for i in range(3):
            s = tt.TransitionSender("127.0.0.1", recv.port, actor_id=f"a{i}",
                                    codec="raw", connect_timeout=5.0)
            senders.append(s)
            s.send(_batch(seed=i))
            deadline = time.monotonic() + 5.0
            while len(seen) < i + 1 and time.monotonic() < deadline:
                time.sleep(0.01)
        assert got.wait(5.0)
        assert seen == [0, 1, 0]
    finally:
        for s in senders:
            s.close()
        recv.close()


def test_traced_frames_record_every_wire_span_and_never_orphan():
    """Raw frames stamped with a trace: admission, decode, stage, merge,
    commit and, after ``mark_grad``, grad; a shed frame ends shed."""
    RECORDER.reset()
    RECORDER.enable(sample_rate=1.0)
    svc = ReplayService(FusedDeviceReplay(256, 4, 2, block_rows=32,
                                          ingest_shards=2, device="cpu"),
                        num_ingest_shards=2)
    try:
        now = time.monotonic()
        for i in range(6):
            tid = (7 << 48) | i
            assert svc.add_payload(_payload(f"a{i % 2}", i,
                                            trace=(tid, now)),
                                   shard=i % 2, codec="raw")
        svc.flush()
        assert RECORDER.mark_grad() == 6
        table = RECORDER.span_table()
        for i in range(6):
            spans = table[(7 << 48) | i]
            assert {"send", "admission", "decode", "stage", "merge",
                    "commit", "grad"} <= set(spans)
            assert spans["send"] <= spans["admission"] <= spans["decode"] \
                <= spans["stage"] <= spans["merge"] <= spans["commit"] \
                <= spans["grad"]
        block = RECORDER.latency_block()
        assert block["wire_to_grad"]["n"] == 6 and block["orphans"] == 0
    finally:
        RECORDER.disable()
        RECORDER.reset()
        svc.close()


def test_shed_traced_frame_ends_shed():
    RECORDER.reset()
    RECORDER.enable(sample_rate=1.0)
    slow = _SlowBuffer(ReplayBuffer(10_000, 4, 2, device="cpu"), 0.05)
    svc = ReplayService(slow, ingest_capacity=2, shed_watermark=0.5,
                        num_ingest_shards=2)
    try:
        now = time.monotonic()
        for i in range(8):
            svc.add_payload(_payload("a0", i, trace=((9 << 48) | i, now)),
                            shard=0, codec="raw")
        svc.flush(timeout=10.0)
        RECORDER.mark_grad()
        block = RECORDER.latency_block()
        stats = svc.ingest_stats()
        assert stats["sheds"] > 0 and block["shed"] == stats["sheds"]
        assert block["orphans"] == 0
    finally:
        RECORDER.disable()
        RECORDER.reset()
        svc.close()


def test_frames_of_an_older_generation_are_fenced():
    RECORDER.reset()
    RECORDER.enable(sample_rate=1.0)
    svc = ReplayService(ReplayBuffer(100, 4, 2, device="cpu"),
                        num_ingest_shards=2)
    try:
        svc._generation = 2  # as a restore would leave it
        now = time.monotonic()
        assert svc.add_payload(_payload("a0", 0, generation=1,
                                        trace=((5 << 48), now)),
                               shard=0, codec="raw") is True
        assert svc.add_payload(_payload("a0", 1, generation=2), shard=1,
                               codec="raw") is True
        svc.flush()
        stats = svc.ingest_stats()
        assert (stats["fenced_frames"], stats["fenced_rows"]) == (1, 8)
        assert svc.env_steps == 8
        assert "shed" in RECORDER.span_table()[5 << 48]
    finally:
        RECORDER.disable()
        RECORDER.reset()
        svc.close()
