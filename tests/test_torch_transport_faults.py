"""The transport's failure semantics and the replay service's
degradation and recovery, re-asserted on the port
(``d4pg_tpu_torch/distributed/transport.py``, ``replay_service.py``):
the 17 cases of ``tests/test_transport_faults.py`` with the port's
modules in place of the reference's.

  - a timed-out send under ``drop_on_timeout`` returns False, never raises;
  - the retry loop keeps its bounded-attempt invariant;
  - a frame that survives a retry arrives bitwise (retried verbatim);
  - an evicted actor that heartbeats again is re-admitted;
  - the shed watermark drops the oldest queued batch, counts it, and never
    blocks the caller; the sharded plane does the same per shard;
  - hostile or undecodable frames are tombstoned and counted, never wedge
    the merge or kill a thread.
"""

import threading
import time

import numpy as np
import pytest

from d4pg_tpu_torch.distributed.replay_service import ReplayService
from d4pg_tpu_torch.distributed.transport import (
    CoalescingSender,
    TransitionReceiver,
    TransitionSender,
)
from d4pg_tpu_torch.replay.uniform import ReplayBuffer, TransitionBatch


pytestmark = pytest.mark.torchport


def _batch(n=8, obs_dim=4, act_dim=2, seed=0):
    rng = np.random.default_rng(seed)
    return TransitionBatch(
        obs=rng.standard_normal((n, obs_dim)).astype(np.float32),
        action=rng.standard_normal((n, act_dim)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.standard_normal((n, obs_dim)).astype(np.float32),
        done=np.zeros(n, np.float32),
        discount=np.full(n, 0.99, np.float32),
    )


def _drain_sender_into_dead_peer(sender, batch, tries=10):
    """Send until the broken pipe is observed (TCP lets the first write
    after a silent peer death land in the kernel buffer)."""
    for _ in range(tries):
        if not sender.send(batch):
            return False
    return True


def test_send_timeout_returns_false_not_raise():
    """drop_on_timeout: exhausting the time budget returns False and
    counts the frame, instead of raising ConnectionError."""
    received = []
    recv = TransitionReceiver(lambda b, aid, c: received.append(b),
                              host="127.0.0.1")
    sender = TransitionSender("127.0.0.1", recv.port, actor_id="t",
                              retry_timeout=0.4, drop_on_timeout=True,
                              backoff_base=0.05)
    assert sender.send(_batch()) is True
    recv.close()  # learner dies
    time.sleep(0.75)  # past the dying listener's teardown grace window
    t0 = time.monotonic()
    ok = _drain_sender_into_dead_peer(sender, _batch())  # no raise
    assert ok is False
    assert time.monotonic() - t0 < 10.0
    assert sender.frames_dropped >= 1
    sender.close()


def test_bounded_retry_attempts_invariant():
    """max_retries caps reconnect attempts per call even under a generous
    time budget: the call returns (False) after exactly that many."""
    recv = TransitionReceiver(lambda b, aid, c: None, host="127.0.0.1")
    sender = TransitionSender("127.0.0.1", recv.port, actor_id="t",
                              retry_timeout=30.0, max_retries=3,
                              drop_on_timeout=True, backoff_base=0.05)
    recv.close()
    time.sleep(0.75)  # past the dying listener's teardown grace window
    retries0 = sender.retries
    t0 = time.monotonic()
    assert _drain_sender_into_dead_peer(sender, _batch()) is False
    elapsed = time.monotonic() - t0
    # the failing call burned exactly max_retries reconnect attempts, and
    # returned long before the 30 s time budget
    assert sender.retries - retries0 == 3
    assert elapsed < 10.0
    # the invariant holds per call: another send spends another 3
    assert sender.send(_batch()) is False
    assert sender.retries - retries0 == 6
    sender.close()


def test_retry_preserves_payload_bitwise():
    """A frame delivered after the learner restarts is bitwise the frame
    that was first attempted: same rows, same dtypes, same actor id."""
    got: list = []
    recv = TransitionReceiver(lambda b, aid, c: got.append((aid, b)),
                              host="127.0.0.1")
    port = recv.port
    sender = TransitionSender("127.0.0.1", port, actor_id="bitwise-7",
                              retry_timeout=20.0, backoff_base=0.05)
    sender.send(_batch(seed=1))
    deadline = time.monotonic() + 5.0
    while not got and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(got) == 1
    got.clear()

    recv.close()  # learner dies mid-run
    template = _batch(seed=42)
    done = threading.Event()
    results: list[bool] = []

    def late_sends():
        # early post-death writes can vanish into the kernel buffer or the
        # dying listener's backlog; keep sending the SAME frame until one
        # delivery lands at the RESTARTED receiver
        deadline = time.monotonic() + 15.0
        while not got and time.monotonic() < deadline:
            results.append(sender.send(template))
            time.sleep(0.05)
        done.set()

    t = threading.Thread(target=late_sends, daemon=True)
    t.start()
    time.sleep(0.7)  # past the dead listener's teardown window
    recv2 = TransitionReceiver(lambda b, aid, c: got.append((aid, b)),
                               host="127.0.0.1", port=port)  # restart
    assert done.wait(timeout=20.0)
    deadline = time.monotonic() + 5.0
    while not got and time.monotonic() < deadline:
        time.sleep(0.01)
    assert got, "no frame delivered to the restarted receiver"
    assert sender.retries >= 1, "delivery did not traverse a retry"
    aid, delivered = got[0]
    assert aid == "bitwise-7"
    for sent_col, recv_col in zip(template, delivered):
        assert recv_col.dtype == sent_col.dtype
        np.testing.assert_array_equal(recv_col, sent_col)  # bitwise
    sender.close()
    recv2.close()


def test_coalescing_sender_sheds_and_shrinks_on_backpressure():
    """The fleet-sender degradation: a timed-out block is shed (counted in
    dropped_rows) and the adaptive target snaps back to min_block."""
    recv = TransitionReceiver(lambda b, aid, c: None, host="127.0.0.1")
    sender = CoalescingSender("127.0.0.1", recv.port, actor_id="c",
                              retry_timeout=0.3, max_retries=2,
                              drop_on_timeout=True, backoff_base=0.05,
                              min_block=4, max_block=64,
                              flush_interval=1e9)
    assert sender.send(_batch(4)) is True  # fills exactly min_block: ships
    recv.close()
    time.sleep(0.75)  # past the dying listener's teardown grace window
    ok = True
    for _ in range(10):  # first post-death writes may land in the buffer
        ok = sender.send(_batch(4))
        if not ok:
            break
    assert ok is False
    assert sender.dropped_rows >= 4
    assert sender._target == sender._min_block
    assert sender.delivered_rows >= 4
    sender.close()


def test_evicted_actor_readmitted_on_heartbeat():
    """Regression: eviction is not a death sentence.
    An evicted actor that heartbeats again must leave dead_actors() and
    be counted as a re-admission with a recovery interval."""
    svc = ReplayService(ReplayBuffer(100, 4, 2), heartbeat_timeout=0.05)
    svc.heartbeat("a0")
    time.sleep(0.1)
    assert svc.dead_actors() == ["a0"]
    assert svc.evict_dead() == ["a0"]
    assert svc.evicted_actors() == ["a0"]
    # evicted and silent: STILL counted dead (eviction must not hide it)
    assert svc.dead_actors() == ["a0"]
    assert svc.evict_dead() == []  # idempotent between state changes

    svc.heartbeat("a0")  # the actor comes back
    assert svc.dead_actors() == []
    assert svc.evicted_actors() == []
    stats = svc.ingest_stats()
    assert stats["evictions"] == 1
    assert stats["readmissions"] == 1
    assert len(stats["recovery_s"]) == 1 and stats["recovery_s"][0] > 0
    svc.close()


def test_evicted_actor_readmitted_by_streaming():
    """add() heartbeats, so a restarted actor re-admits itself with its
    first delivered batch — no separate control channel needed."""
    svc = ReplayService(ReplayBuffer(100, 4, 2), heartbeat_timeout=0.05)
    svc.add(_batch(), actor_id="a1")
    time.sleep(0.1)
    svc.evict_dead()
    assert svc.dead_actors() == ["a1"]
    svc.add(_batch(), actor_id="a1")  # the restarted actor streams again
    assert svc.dead_actors() == []
    assert svc.ingest_stats()["readmissions"] == 1
    svc.flush()
    assert len(svc) == 16
    svc.close()


class _SlowBuffer:
    """ReplayBuffer veneer whose inserts take forever — forces the ingest
    queue to back up so the shed path is exercised deterministically."""

    def __init__(self, inner: ReplayBuffer, delay_s: float):
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


def test_shed_watermark_drops_oldest_counted_never_blocks():
    slow = _SlowBuffer(ReplayBuffer(10_000, 4, 2), delay_s=0.05)
    svc = ReplayService(slow, ingest_capacity=4, shed_watermark=0.5)
    t0 = time.monotonic()
    for i in range(12):
        # never blocks, always True — the watermark sheds instead
        assert svc.add(_batch(seed=i), actor_id="a0", block=False) is True
    assert time.monotonic() - t0 < 1.0  # 12 adds never waited on inserts
    svc.flush(timeout=10.0)
    stats = svc.ingest_stats()
    assert stats["sheds"] > 0
    assert stats["shed_rows"] == 8 * stats["sheds"]
    # conservation: every accepted batch was inserted or counted shed
    assert slow.inserted_batches + stats["sheds"] == 12
    # env_steps counts INSERTED rows only — shed rows never inflate it
    assert svc.env_steps == 8 * slow.inserted_batches
    assert stats["pending"] == 0
    svc.close()


def test_shed_disabled_keeps_block_contract():
    """Without a watermark the pre-fleet contract holds: a full queue
    returns False on the non-blocking path (no silent shedding)."""
    slow = _SlowBuffer(ReplayBuffer(10_000, 4, 2), delay_s=0.05)
    svc = ReplayService(slow, ingest_capacity=2)
    results = [svc.add(_batch(seed=i), actor_id="a0", block=False,
                       timeout=0.01) for i in range(10)]
    assert False in results  # backpressure surfaced, not absorbed
    assert svc.ingest_stats()["sheds"] == 0
    svc.flush(timeout=10.0)
    svc.close()


def test_shed_watermark_at_k2_per_shard_counted_never_blocks():
    """Regression at K=2: the shed watermark is a
    PER-SHARD contract — each shard sheds its own oldest, counts it
    under its own lock, and the service totals close the conservation
    equation exactly as at K=1."""
    slow = _SlowBuffer(ReplayBuffer(10_000, 4, 2), delay_s=0.05)
    svc = ReplayService(slow, ingest_capacity=4, shed_watermark=0.5,
                        num_ingest_shards=2)
    t0 = time.monotonic()
    for i in range(12):
        # never blocks, always True — the watermark sheds instead
        assert svc.add(_batch(seed=i), actor_id=f"a{i % 2}",
                       block=False, shard=i % 2) is True
    assert time.monotonic() - t0 < 1.0
    svc.flush(timeout=10.0)
    stats = svc.ingest_stats()
    assert stats["sheds"] > 0
    assert stats["shed_rows"] == 8 * stats["sheds"]
    # conservation: every accepted batch was committed or counted shed
    assert slow.inserted_batches + stats["sheds"] == 12
    assert svc.env_steps == 8 * slow.inserted_batches
    assert stats["pending"] == 0
    assert stats["order_breaks"] == 0
    # the per-shard ledgers sum to the service totals
    per = stats["per_shard"]
    assert len(per) == 2
    assert sum(p["sheds"] for p in per) == stats["sheds"]
    assert sum(p["rows_in"] for p in per) == 12 * 8
    svc.close()


def test_crash_readmission_at_k2():
    """Regression at K=2: eviction/re-admission bookkeeping is global
    across shards — an actor owned by shard 1 that dies and later
    streams through shard 0 is re-admitted, not double-counted."""
    svc = ReplayService(ReplayBuffer(100, 4, 2), heartbeat_timeout=0.05,
                        num_ingest_shards=2)
    svc.add(_batch(), actor_id="a1", shard=1)
    time.sleep(0.1)
    assert svc.evict_dead() == ["a1"]
    assert svc.dead_actors() == ["a1"]
    svc.add(_batch(), actor_id="a1", shard=0)  # restarts on another shard
    assert svc.dead_actors() == []
    stats = svc.ingest_stats()
    assert stats["evictions"] == 1 and stats["readmissions"] == 1
    assert len(stats["recovery_s"]) == 1 and stats["recovery_s"][0] > 0
    svc.flush()
    assert len(svc) == 16
    svc.close()


def test_raw_codec_bitwise_matches_npz():
    """The v2 raw frame must decode to exactly what the npz frame does:
    same arrays, dtypes, actor id and count flag — it is a wire-format
    change, not a semantic one."""
    from d4pg_tpu_torch.distributed.transport import (
        _HEADER, _decode, _encode, decode_raw, encode_raw, raw_frame_meta)

    batch = _batch(n=16, seed=9)
    for count in (True, False):
        raw = encode_raw("actor-x", batch, count)[_HEADER.size:]
        npz = _encode("actor-x", batch, count)[_HEADER.size:]
        aid_r, got_r, cnt_r = decode_raw(raw)
        aid_n, got_n, cnt_n = _decode(npz)
        assert aid_r == aid_n == "actor-x"
        assert cnt_r == cnt_n == count
        for r, n in zip(got_r, got_n):
            assert r.dtype == n.dtype
            np.testing.assert_array_equal(r, n)
        # the header-only metadata path (zero-decode admission) agrees
        assert raw_frame_meta(raw) == ("actor-x", 16, count)


def test_payload_decode_error_tombstoned_not_wedged():
    """A corrupt raw payload admitted to a shard must be counted
    (decode_errors) and tombstoned — later frames still commit in order
    instead of the merge wedging behind the dead ticket."""
    from d4pg_tpu_torch.distributed.transport import _HEADER, encode_raw

    svc = ReplayService(ReplayBuffer(1000, 4, 2), num_ingest_shards=2,
                        shed_watermark=0.9)
    good = encode_raw("a0", _batch(), True)[_HEADER.size:]
    # intact header (admission metadata parses fine) but truncated
    # columns: the failure surfaces at WORKER decode, after admission
    corrupt = good[:-50]
    assert svc.add_payload(good, shard=0, codec="raw") is True
    assert svc.add_payload(corrupt, shard=1, codec="raw") is True
    assert svc.add_payload(good, shard=1, codec="raw") is True
    svc.flush(timeout=10.0)
    stats = svc.ingest_stats()
    assert svc.env_steps == 16  # both good frames landed
    assert stats["decode_errors"] >= 1
    assert stats["pending"] == 0
    svc.close()


def test_sender_backoff_jitter_seeded_reproducible():
    """Seeded backoff jitter draws an identical schedule — the fleet
    harness's reproducibility reaches into the retry path."""
    recv = TransitionReceiver(lambda b, aid, c: None, host="127.0.0.1")

    def failing_schedule(seed):
        s = TransitionSender("127.0.0.1", recv.port, actor_id="j",
                             retry_timeout=1.0, max_retries=2,
                             drop_on_timeout=True, backoff_base=0.01,
                             backoff_seed=seed)
        draws = [float(s._backoff_rng.random()) for _ in range(8)]
        s.close()
        return draws

    assert failing_schedule(5) == failing_schedule(5)
    assert failing_schedule(5) != failing_schedule(6)
    recv.close()


def test_add_payload_without_watermark_blocks_not_drops():
    """Regression (high severity): with NO shed watermark (train.py's
    default wiring) a full ingest shard must give the sharded receiver
    the same blocking backpressure the K=1 path has — a learner stall
    must never silently discard frames off add_payload."""
    from d4pg_tpu_torch.distributed.transport import _HEADER, encode_raw

    slow = _SlowBuffer(ReplayBuffer(10_000, 4, 2), delay_s=0.01)
    svc = ReplayService(slow, ingest_capacity=2, num_ingest_shards=2)
    frames = [encode_raw(f"a{i % 2}", _batch(seed=i), True)[_HEADER.size:]
              for i in range(16)]
    # far past per-shard capacity: pre-fix, the non-blocking admission
    # returned False on a full deque and the frame vanished uncounted
    results = [svc.add_payload(f, shard=i % 2, codec="raw")
               for i, f in enumerate(frames)]
    assert all(results)  # blocking admission absorbed the burst
    svc.flush(timeout=10.0)
    stats = svc.ingest_stats()
    assert svc.env_steps == 16 * 8  # every frame landed
    assert stats["sheds"] == 0
    assert stats["admit_fails"] == 0
    assert stats["pending"] == 0
    svc.close()


def test_stale_ticket_below_merge_floor_discarded_not_wedged():
    """Regression (medium severity): a ticket the order-break valve
    skipped past (worker held its group through the grace) later lands
    at the head of its shard's outbox with seq < the merge floor. It
    must be discarded and counted — not left as a forever-unpoppable
    head that gates the shard's worker and wedges flush()/close()."""
    import itertools

    svc = ReplayService(ReplayBuffer(1000, 4, 2), num_ingest_shards=2)
    b = _batch()
    with svc._lock:
        svc._pending += 2
    with svc._commit_cond:
        svc._next_seq = 5  # the valve already advanced past ticket 3
        svc._seq = itertools.count(6)
        svc._out[0].append((3, "a0", b, 8, True, None))  # the late ticket
        svc._out[1].append((5, "a1", b, 8, True, None))  # current floor head
        svc._commit_cond.notify_all()
    svc.flush(timeout=5.0)
    stats = svc.ingest_stats()
    assert stats["pending"] == 0  # flush drained — no wedge
    assert stats["order_breaks"] >= 1  # the discard was counted
    assert svc.env_steps == 8  # only the floor ticket committed
    assert len(svc) == 8
    with svc._commit_cond:
        assert not svc._out[0]  # the stale head is gone, worker ungated
    svc.close()


def test_order_break_valve_prunes_stale_tombstones(monkeypatch):
    """Regression (low severity): when the safety valve advances the merge
    floor, tombstones below it can never be consumed by the equality
    walk — they must be pruned, not accumulate for the service
    lifetime."""
    import itertools

    import d4pg_tpu_torch.distributed.replay_service as rs

    monkeypatch.setattr(rs, "_ORDER_GRACE_S", 0.2)
    svc = ReplayService(ReplayBuffer(1000, 4, 2), num_ingest_shards=2)
    b = _batch()
    with svc._lock:
        svc._pending += 1
    with svc._commit_cond:
        svc._skip.update({1, 2})  # tombstones below the coming jump
        svc._seq = itertools.count(8)
        svc._out[0].append((7, "a0", b, 8, True, None))  # tickets 0-6 vanished
        svc._commit_cond.notify_all()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and svc.env_steps < 8:
        time.sleep(0.02)
    assert svc.env_steps == 8  # the valve skipped ahead and committed
    stats = svc.ingest_stats()
    assert stats["order_breaks"] >= 1
    assert stats["pending"] == 0
    with svc._commit_cond:
        assert not svc._skip  # pruned at the jump, not grown forever
    svc.close()


def test_corrupt_v2_frame_drops_connection_without_thread_crash():
    """Regression (low severity): a well-framed but hostile v2 payload
    raises struct.error/UnicodeDecodeError (not ProtocolError) out of
    decode_raw; the unsharded serve loop must drop the connection
    silently — not die with an unhandled-exception traceback — and keep
    serving new connections."""
    import socket as socket_mod

    from d4pg_tpu_torch.distributed.transport import _HEADER, _MAGIC_RAW

    crashes = []
    orig_hook = threading.excepthook
    threading.excepthook = lambda a: crashes.append(a)
    try:
        received = []
        recv = TransitionReceiver(lambda b, aid, c: received.append(b),
                                  host="127.0.0.1")
        c = socket_mod.create_connection(("127.0.0.1", recv.port))
        # valid frame header; body parses as count=255, actor-id length
        # 255 and then UnicodeDecodeError on the \xff actor-id bytes
        garbage = b"\xff" * 64
        c.sendall(_HEADER.pack(_MAGIC_RAW, len(garbage)) + garbage)
        c.settimeout(5.0)
        assert c.recv(1) == b""  # server dropped the connection...
        c.close()
        # ...and the plane still serves: a fresh sender lands a frame
        sender = TransitionSender("127.0.0.1", recv.port, actor_id="ok")
        assert sender.send(_batch()) is True
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not received:
            time.sleep(0.02)
        assert len(received) == 1
        assert not crashes  # serve thread exited cleanly, no traceback
        sender.close()
        recv.close()
    finally:
        threading.excepthook = orig_hook
