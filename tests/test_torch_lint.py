"""The port's lint (``d4pg_tpu_torch.lint``) against its reference.

The fixtures of the reference's ``tests/test_lint.py`` for the 13
framework-neutral families it carries (lock-order, the lock graph, the
wire registry, the exception-flow graph), its suppression mechanics and
its CLI: each rule must fire on a known-bad snippet and stay silent on
the known-good variant. The three suppression tests, the CLI exit-code
test and the default ``--json`` test used JAX-only families as their
fixtures; they use carried ones here.

``test_parity_with_reference`` runs both lints, with the carried
families only, on every fixture source of this file and asserts the
same ``(rule, line, col)`` findings. The one intended difference is call
resolution: the port's lock graph binds no builtin call, no call on an
imported module and no attribute call to a program method or closure of
that name (``RESOLUTION_FIXTURES``), where the reference does.

The fixtures deliberately contain the hazards the rules hunt — none of
this code is ever executed, only parsed.
"""

import ast
import textwrap
from pathlib import Path

import pytest

from d4pg_tpu.lint import lint_source as reference_lint_source
from d4pg_tpu_torch.lint import RULES, lint_paths, lint_source
from d4pg_tpu_torch.lint.__main__ import main as lint_main

pytestmark = pytest.mark.torchport

# the reference's framework-neutral families, the ones the port carries
CARRIED = (
    "lock-order", "lock-cycle", "unguarded-shared-write",
    "wire-magic-registry", "codec-asymmetry", "unchecked-frame",
    "flag-bit-collision", "thread-crash-containment",
    "span-terminal-missing", "ledger-conservation", "rng-ambient-stream",
    "rng-stream-thread-escape", "rng-draw-count-drift",
)


def findings(src, rule=None):
    res = lint_source(textwrap.dedent(src), "fixture.py")
    assert not res.errors, res.errors
    out = res.findings
    return [f for f in out if f.rule == rule] if rule else out


# ----------------------------------------------------- suppressions -------

def test_inline_suppression():
    res = lint_source(textwrap.dedent("""
        import threading

        class Stats:
            def __init__(self):
                self._lock = threading.Lock()
                self.rows = 0

            def bump(self, n):
                with self._lock:
                    self.rows += n

            def snapshot(self):
                with self._lock:
                    return {"rows": self.rows}

            def fast_path(self, n):
                self.rows += n  # jaxlint: disable=unguarded-shared-write
        """), "fixture.py")
    assert res.findings == [] and len(res.suppressed) == 1
    assert res.clean


def test_file_wide_suppression():
    res = lint_source(textwrap.dedent("""
        # jaxlint: disable-file=unguarded-shared-write
        import threading

        class Stats:
            def __init__(self):
                self._lock = threading.Lock()
                self.rows = 0

            def bump(self, n):
                with self._lock:
                    self.rows += n

            def snapshot(self):
                with self._lock:
                    return {"rows": self.rows}

            def fast_path(self, n):
                self.rows += n
        """), "fixture.py")
    assert res.findings == [] and len(res.suppressed) == 1


def test_suppression_is_rule_specific():
    res = lint_source(textwrap.dedent("""
        import threading

        class Stats:
            def __init__(self):
                self._lock = threading.Lock()
                self.rows = 0

            def bump(self, n):
                with self._lock:
                    self.rows += n

            def snapshot(self):
                with self._lock:
                    return {"rows": self.rows}

            def fast_path(self, n):
                self.rows += n  # jaxlint: disable=lock-order
        """), "fixture.py")
    assert len(res.findings) == 1


# -------------------------------------------------------------- CLI -------

def test_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""
        import threading

        class Stats:
            def __init__(self):
                self._lock = threading.Lock()
                self.rows = 0

            def bump(self, n):
                with self._lock:
                    self.rows += n

            def snapshot(self):
                with self._lock:
                    return {"rows": self.rows}

            def fast_path(self, n):
                self.rows += n
        """))
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert lint_main([str(bad)]) == 1
    assert "unguarded-shared-write" in capsys.readouterr().out
    assert lint_main([str(good)]) == 0
    assert lint_main(["--list-rules"]) == 0
    assert lint_main([str(bad), "--rules", "lock-order"]) == 0
    assert lint_main([str(bad), "--rules", "no-such-rule"]) == 2


def test_rule_catalog_covers_all_families():
    """The 13 framework-neutral families of the reference, by its ids."""
    assert set(RULES) == set(CARRIED)
    assert len(RULES) == 13
    assert RULES["lock-order"].scope == "module"
    # the graph families analyze whole programs, not single modules
    for rule in CARRIED:
        if rule != "lock-order":
            assert RULES[rule].scope == "program"
    assert not {"prng-key-reuse", "host-sync-in-jit", "recompile-hazard",
                "use-after-donation", "tracer-leak", "device-put-in-loop",
                "host-time-in-jit", "sharding-rule-bypass",
                "collective-axis-unbound", "sharding-spec-drift",
                "donation-alias"} & set(RULES)


def test_lock_order_fires_on_buffer_lock_under_shard_cond():
    out = findings("""
        class Service:
            def bad(self, shard, batch):
                with shard.cond:
                    with self._buffer_lock:
                        self.buffer.add(batch)
        """, "lock-order")
    assert len(out) == 1
    assert "'cond'" in out[0].message


def test_lock_order_fires_on_acquire_and_ring_locks():
    out = findings("""
        class Staging:
            def bad(self, i):
                with self._ring_locks[i]:
                    self._lock.acquire()
                    try:
                        self.n += 1
                    finally:
                        self._lock.release()
        """, "lock-order")
    assert len(out) == 1


def test_lock_order_clean_patterns():
    # sequential (non-nested) acquisition and leaf-last nesting are the
    # documented discipline — neither may fire
    out = findings("""
        class Service:
            def good(self, shard, batch):
                with shard.cond:
                    shard.q.append(batch)
                with self._buffer_lock:
                    self.buffer.add(batch)
                with self._lock:
                    self.pending -= 1

            def also_good(self, shard):
                with self._buffer_lock:
                    with shard.cond:
                        return len(shard.q)

            def new_scope_resets(self, shard):
                with shard.cond:
                    def helper(self):
                        with self._buffer_lock:
                            return 1  # different thread's scope
                    return helper
        """, "lock-order")
    assert out == []


def test_syntax_error_reported_not_raised(tmp_path):
    res = lint_source("def broken(:\n", "broken.py")
    assert res.errors and not res.clean


def test_lock_cycle_fires_on_cross_function_abba():
    """The shape the syntactic lock-order rule CANNOT see: each function
    nests correctly in isolation; the ABBA cycle only exists through the
    call edges (worker holds the shard cond into a helper that takes the
    merge cond; the committer holds the merge cond into a helper that
    takes the shard cond)."""
    out = findings("""
        class Service:
            def worker(self, shard):
                with shard.cond:
                    self._hand_off(shard)

            def _hand_off(self, shard):
                with self._commit_cond:
                    self._commit_cond.notify_all()

            def committer(self, shard):
                with self._commit_cond:
                    self._drain_one(shard)

            def _drain_one(self, shard):
                with shard.cond:
                    return shard.q.popleft()
        """, "lock-cycle")
    assert len(out) == 1
    assert "cond" in out[0].message and "_commit_cond" in out[0].message
    assert "deadlock" in out[0].message


def test_lock_cycle_fires_on_direct_abba():
    out = findings("""
        class S:
            def a(self):
                with self._ring_locks[0]:
                    with self._buffer_lock:
                        pass

            def b(self):
                with self._buffer_lock:
                    with self._ring_locks[1]:
                        pass
        """, "lock-cycle")
    assert len(out) == 1


def test_lock_cycle_clean_on_consistent_order():
    """Hierarchy-consistent nesting — even deep through calls — must not
    fire: every path acquires in one global order."""
    out = findings("""
        class Service:
            def committer(self, shard):
                with self._buffer_lock:
                    self._insert(shard)

            def _insert(self, shard):
                with shard.ring_lock:
                    shard.rows.clear()

            def sampler(self):
                with self._buffer_lock:
                    with self._ring_locks[0]:
                        return 1

            def sequential(self, shard):
                with shard.cond:
                    shard.q.clear()
                with self._buffer_lock:
                    return 2
        """, "lock-cycle")
    assert out == []


def test_lock_cycle_merge_wedge_regression():
    """Acceptance bar: re-introducing the merge-wedge DISCIPLINE
    REVERT — the shard worker waiting on merge-inbox state while still
    holding its shard condition — is caught statically even though the
    commit-cond acquisition is a call away (the runtime twin of this
    regression lives in test_locking.py::test_merge_wedge_shape_is_caught
    on the real service objects)."""
    out = findings("""
        class ReplayService:
            def _worker(self, s):
                with s.cond:
                    items = self._pop_coalesced(s)
                    self._wait_for_inbox(s)   # REVERTED: was outside s.cond
                    return items

            def _wait_for_inbox(self, s):
                with self._commit_cond:
                    while self._out[s.idx]:
                        self._commit_cond.wait(0.1)

            def _commit_loop(self):
                with self._commit_cond:
                    group = self._pop_ready()
                for s in self._shards:
                    self._settle(s)

            def _pop_ready(self):
                return list(self._out)

            def _settle(self, s):
                with s.cond:
                    s.cond.notify_all()
        """)
    cyc = [f for f in out if f.rule == "lock-cycle"]
    assert len(cyc) == 1
    assert "cond" in cyc[0].message and "_commit_cond" in cyc[0].message


def test_unguarded_write_fires_on_naked_counter():
    """A genuine unguarded counter: every other access takes the lock;
    the hot-path increment skips it."""
    out = findings("""
        import threading

        class Stats:
            def __init__(self):
                self._lock = threading.Lock()
                self.rows = 0

            def bump(self, n):
                with self._lock:
                    self.rows += n

            def snapshot(self):
                with self._lock:
                    return {"rows": self.rows}

            def fast_path(self, n):
                self.rows += n   # racy read-modify-write
        """, "unguarded-shared-write")
    assert len(out) == 1
    assert "'rows'" in out[0].message and "'_lock'" in out[0].message
    assert "guarded-by" in out[0].message


def test_unguarded_write_satisfied_by_annotation():
    """`# jaxlint: guarded-by=<lock>` declares the caller-holds-it
    contract (line-level or def-level) and satisfies the checker."""
    out = findings("""
        import threading

        class Stats:
            def __init__(self):
                self._lock = threading.Lock()
                self.rows = 0

            def bump(self, n):
                with self._lock:
                    self.rows += n

            def snapshot(self):
                with self._lock:
                    return {"rows": self.rows}

            def _bump_locked(self, n):  # jaxlint: guarded-by=_lock
                self.rows += n

            def line_level(self, n):
                self.rows += n  # jaxlint: guarded-by=_lock
        """, "unguarded-shared-write")
    assert out == []


def test_unguarded_write_inherits_caller_lock():
    """A helper whose EVERY call site holds the lock is guarded by
    inheritance — no annotation needed (the _pop_ready pattern: writes
    under the commit condition held by the caller)."""
    out = findings("""
        import threading

        class Merge:
            def __init__(self):
                self._commit_cond = threading.Condition()
                self.order_breaks = 0

            def loop(self):
                with self._commit_cond:
                    self._pop_ready()

            def valve(self):
                with self._commit_cond:
                    self._pop_ready()
                    self.order_breaks += 1

            def _pop_ready(self):
                self.order_breaks += 1
        """, "unguarded-shared-write")
    assert out == []


def test_unguarded_write_silent_without_majority():
    """Single-writer attributes read without the lock everywhere are NOT
    lock-owned — inference must stay silent rather than guess."""
    out = findings("""
        import threading

        class Ring:
            def __init__(self):
                self._lock = threading.Lock()
                self.head = 0

            def write(self):
                with self._lock:
                    self.head += 1

            def reader_a(self):
                return self.head

            def reader_b(self):
                return self.head + 1
        """, "unguarded-shared-write")
    assert out == []


def test_lock_graph_cli_mode(tmp_path, capsys):
    """`--locks` prints the graph artifact; exit 1 iff a cycle exists."""
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""
        class S:
            def a(self):
                with self._ring_locks[0]:
                    with self._buffer_lock:
                        pass

            def b(self):
                with self._buffer_lock:
                    with self._ring_locks[1]:
                        pass
        """))
    assert lint_main(["--locks", str(bad)]) == 1
    out = capsys.readouterr().out
    assert "_buffer_lock" in out and "_ring_locks" in out
    assert "cycles:" in out and "edges" in out

    good = tmp_path / "good.py"
    good.write_text(textwrap.dedent("""
        class S:
            def a(self):
                with self._buffer_lock:
                    with self._ring_locks[0]:
                        pass
        """))
    assert lint_main(["--locks", str(good)]) == 0
    out = capsys.readouterr().out
    assert "cycles: none" in out
    assert "_buffer_lock -> _ring_locks" in out


def test_wire_magic_registry_fires_on_unregistered_magic():
    out = findings("""
        import struct

        def encode(payload):
            return struct.pack("!HI", 0xD412, len(payload)) + payload
        """, "wire-magic-registry")
    assert len(out) == 1
    assert "0xD412" in out[0].message and "absent" in out[0].message


def test_wire_magic_registry_fires_on_private_redeclare():
    out = findings("""
        import struct

        _MAGIC = 0xD4F6  # privately re-declares the ingest-v1 magic

        def encode(payload):
            return struct.pack("!II", _MAGIC, len(payload)) + payload
        """, "wire-magic-registry")
    assert len(out) == 1
    assert "re-declares" in out[0].message
    assert "d4pg_tpu_torch.core.wire" in out[0].message


def test_wire_magic_registry_exempts_seed_literals():
    out = findings("""
        import numpy as np

        def rng(seed, replica):
            ss = np.random.SeedSequence(seed, spawn_key=(0xD4E4, replica))
            return np.random.default_rng(seed ^ 0xD4E3)
        """, "wire-magic-registry")
    assert out == []


def test_wire_magic_registry_fires_on_undeclared_flag_bit():
    out = findings("""
        import struct

        SFLAG_PRIORITY = 0x08  # bit never allocated in the registry

        def check(magic):
            return magic == 0xD4E2
        """, "wire-magic-registry")
    assert len(out) == 1
    assert "flag bit 0x08" in out[0].message


def test_codec_asymmetry_fires_on_format_drift():
    # decoder reads three fields where the ingest header declares two
    out = findings("""
        import struct

        def decode(head):
            if not head:
                return None
            try:
                got, length, extra = struct.unpack("!IIH", head)
            except struct.error:
                return None
            return got == 0xD4F6
        """, "codec-asymmetry")
    assert len(out) == 1
    assert "'!IIH'" in out[0].message and "segment" in out[0].message


def test_codec_asymmetry_fires_on_size_const_drift():
    out = findings("""
        import struct

        HDR = struct.Struct("!II")
        HDR_SIZE = 12  # calcsize says 8
        """, "codec-asymmetry")
    assert len(out) == 1
    assert "HDR_SIZE = 12" in out[0].message and "= 8" in out[0].message


def test_codec_asymmetry_fires_on_argument_count_drift():
    out = findings("""
        import struct

        def greet(gen, extra):
            return struct.pack("!HI", 0xD4FA, gen, extra)
        """, "codec-asymmetry")
    drift = [f for f in out if "2 field(s)" in f.message]
    assert len(drift) == 1
    assert "3 argument(s)" in drift[0].message


def test_codec_asymmetry_fires_on_one_sided_magic():
    out = findings("""
        import struct

        def greet(gen):
            return struct.pack("!HI", 0xD4FA, gen)
        """, "codec-asymmetry")
    assert len(out) == 1
    assert "one-sided" in out[0].message


def test_codec_asymmetry_clean_on_split_reads():
    # weight_plane's idiom: magic read separately, then the remainder of
    # the declared request format — both are contiguous field segments
    out = findings("""
        import struct

        _REQ = struct.Struct("!IqIBB")

        def serve(conn, recv_exact):
            head = recv_exact(conn, 4)
            if head is None:
                return None
            (magic,) = struct.unpack("!I", head)
            if magic != 0xD4FC:
                return None
            rest = recv_exact(conn, _REQ.size - 4)
            have, gen, codec, flags = struct.unpack("!qIBB", rest)
            return have, gen, codec, flags
        """, "codec-asymmetry")
    assert out == []


def test_unchecked_frame_fires_on_naked_recv_unpack():
    out = findings("""
        import struct

        def serve(sock):
            head = sock.recv(64)
            magic, length = struct.unpack("!II", head)
            return sock.recv(length)
        """, "unchecked-frame")
    assert len(out) == 1
    assert "struct.error containment" in out[0].message


def test_unchecked_frame_clean_on_contained_or_exact_read():
    out = findings("""
        import struct

        HDR = struct.Struct("!II")

        def serve_contained(sock):
            head = sock.recv(64)
            try:
                magic, length = struct.unpack("!II", head)
            except struct.error:
                return None
            return magic, length

        def serve_exact(sock):
            head = sock.recv(HDR.size)
            magic, length = HDR.unpack(head)
            return magic, length
        """, "unchecked-frame")
    assert out == []


def test_unchecked_frame_fires_on_parse_before_crc():
    # weights-v2 declares crc32-payload: np.load before any crc32 call
    # on the path is a torn-frame acceptance hazard even when contained
    out = findings("""
        import io
        import struct

        import numpy as np

        def pull(sock):
            head = sock.recv(13)
            magic, kind, crc, length = struct.unpack("!IBII", head)
            if magic != 0xD4FC:
                return None
            payload = sock.recv(length)
            try:
                with np.load(io.BytesIO(payload)) as z:
                    return dict(z)
            except ValueError:
                return None
        """, "unchecked-frame")
    assert len(out) == 1
    assert "crc32" in out[0].message


def test_unchecked_frame_clean_when_crc_checked_first():
    out = findings("""
        import io
        import struct
        import zlib

        import numpy as np

        def pull(sock):
            head = sock.recv(13)
            magic, kind, crc, length = struct.unpack("!IBII", head)
            if magic != 0xD4FC:
                return None
            payload = sock.recv(length)
            if zlib.crc32(payload) != crc:
                return None
            try:
                with np.load(io.BytesIO(payload)) as z:
                    return dict(z)
            except ValueError:
                return None
        """, "unchecked-frame")
    assert out == []


def test_flag_bit_collision_fires_on_registry_conflict():
    out = findings("""
        import struct

        F_TENANT = 0x01  # bit 0 of the serving flag byte is 'trace'

        def check(magic):
            return magic == 0xD4E2
        """, "flag-bit-collision")
    assert len(out) == 1
    assert "already allocated to 'trace'" in out[0].message


def test_flag_bit_collision_fires_on_two_local_claims():
    out = findings("""
        import struct

        F_AAA = 0x08
        FLAG_BBB = 0x08  # same undeclared bit, different meaning

        def check(magic):
            return magic == 0xD4E2
        """, "flag-bit-collision")
    assert len(out) == 1
    assert "FLAG_BBB" in out[0].message and "F_AAA" in out[0].message


def test_flag_bit_collision_clean_on_consistent_mirror():
    # a local alias of a declared bit with a matching meaning is the
    # sanctioned pattern (transport's _F_TRACE before the registry)
    out = findings("""
        import struct

        _F_TRACE = 0x02

        def check(magic):
            return magic == 0xD4F8
        """, "flag-bit-collision")
    assert out == []


def test_wire_cli_mode(tmp_path, capsys):
    """`--wire` prints the registry artifact; exit 1 iff a family fires."""
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""
        import struct

        def encode(payload):
            return struct.pack("!HI", 0xD412, len(payload)) + payload
        """))
    assert lint_main(["--wire", str(bad)]) == 1
    out = capsys.readouterr().out
    assert "0xD412" in out and "findings:" in out

    good = tmp_path / "good.py"
    good.write_text(textwrap.dedent("""
        import struct

        HDR = struct.Struct("!II")

        def greet(sock, gen):
            sock.sendall(struct.pack("!HI", 0xD4FA, gen))

        def read_greeting(sock):
            head = sock.recv(6)
            try:
                magic, gen = struct.unpack("!HI", head)
            except struct.error:
                return None
            if magic != 0xD4FA:
                return None
            return gen
        """))
    assert lint_main(["--wire", str(good)]) == 0
    out = capsys.readouterr().out
    assert "0xD4FA" in out and "findings: none" in out


@pytest.mark.failflow
def test_thread_containment_fires_on_escaping_target():
    out = findings("""
        import threading

        class Plane:
            def start(self):
                self._t = threading.Thread(target=self._serve, daemon=True)
                self._t.start()

            def _serve(self):
                while True:
                    self.handle_one()
        """, "thread-crash-containment")
    assert len(out) == 1
    assert "die silently" in out[0].message


@pytest.mark.failflow
def test_thread_containment_clean_on_caught_and_counted():
    out = findings("""
        import threading

        class Plane:
            def start(self):
                self._t = threading.Thread(target=self._serve, daemon=True)
                self._t.start()

            def _serve(self):
                try:
                    while True:
                        self.handle_one()
                except Exception:
                    self.contained_crashes += 1
        """, "thread-crash-containment")
    assert out == []


@pytest.mark.failflow
def test_thread_containment_fires_on_uncounted_handler():
    out = findings("""
        import threading

        class Plane:
            def start(self):
                self._t = threading.Thread(target=self._serve, daemon=True)
                self._t.start()

            def _serve(self):
                try:
                    while True:
                        self.handle_one()
                except Exception:
                    pass
        """, "thread-crash-containment")
    assert len(out) == 1
    assert "without counting" in out[0].message


@pytest.mark.failflow
def test_thread_containment_fires_on_reraising_handler():
    out = findings("""
        import threading

        class Plane:
            def start(self):
                self._t = threading.Thread(target=self._serve, daemon=True)
                self._t.start()

            def _serve(self):
                try:
                    while True:
                        self.handle_one()
                except Exception:
                    self.contained_crashes += 1
                    raise
        """, "thread-crash-containment")
    assert len(out) == 1
    assert "die silently" in out[0].message


@pytest.mark.failflow
def test_thread_containment_fires_on_unresolvable_target():
    out = findings("""
        import threading

        def launch(lanes):
            for lane in lanes:
                t = threading.Thread(target=lane.run, daemon=True)
                t.start()
        """, "thread-crash-containment")
    assert len(out) == 1
    assert "does not resolve" in out[0].message


@pytest.mark.failflow
def test_thread_containment_contained_by_declaration_satisfies():
    out = findings("""
        import threading

        class Lane:
            def run(self):
                try:
                    self.spin()
                except Exception:
                    self.crashes += 1

        def launch(lanes):
            for lane in lanes:
                t = threading.Thread(target=lane.run, daemon=True)  # jaxlint: contained-by=Lane.run
                t.start()
        """, "thread-crash-containment")
    assert out == []


@pytest.mark.failflow
def test_thread_containment_contained_by_weak_handler_fires():
    out = findings("""
        import threading

        class Lane:
            def run(self):
                self.spin()

        def launch(lanes):
            for lane in lanes:
                t = threading.Thread(target=lane.run, daemon=True)  # jaxlint: contained-by=Lane.run
                t.start()
        """, "thread-crash-containment")
    assert len(out) == 1
    assert "not itself contained-and-counted" in out[0].message


@pytest.mark.failflow
def test_span_terminal_fires_on_raise_path_orphan():
    out = findings("""
        class Plane:
            def handle(self, frame):
                tid = self.next_id()
                TRACE.begin(tid, 0.0)
                payload = self.decode(frame)
                TRACE.mark_committed(tid)
        """, "span-terminal-missing")
    assert len(out) == 1
    assert "orphaned span" in out[0].message


@pytest.mark.failflow
def test_span_terminal_clean_on_exception_edge_shed():
    out = findings("""
        class Plane:
            def handle(self, frame):
                tid = self.next_id()
                TRACE.begin(tid, 0.0)
                try:
                    payload = self.decode(frame)
                except Exception:
                    TRACE.terminal_shed(tid)
                    raise
                TRACE.mark_committed(tid)
        """, "span-terminal-missing")
    assert out == []


@pytest.mark.failflow
def test_span_terminal_clean_on_escrowed_root():
    # the trace id rides the queue entry out of the frame: custody is
    # handed off, not orphaned
    out = findings("""
        class Plane:
            def admit(self, frame):
                tid = self.next_id()
                TRACE.begin(tid, 0.0)
                self.pending[tid] = frame
        """, "span-terminal-missing")
    assert out == []


@pytest.mark.failflow
def test_ledger_fires_on_unaccounted_admission():
    out = findings("""
        class Plane:
            def admit(self, frame):
                self.frames += 1
                payload = self.decode(frame)
                self.apply_update(payload)
        """, "ledger-conservation")
    assert len(out) == 1
    assert "vanish from the ledger" in out[0].message


@pytest.mark.failflow
def test_ledger_clean_on_counted_dispositions():
    out = findings("""
        class Plane:
            def admit(self, frame):
                self.frames += 1
                try:
                    payload = self.decode(frame)
                except Exception:
                    self.torn += 1
                    return
                self.pending.append(payload)
        """, "ledger-conservation")
    assert out == []


@pytest.mark.failflow
def test_fail_cli_mode(tmp_path, capsys):
    """`--fail` prints the exception-flow artifact; exit 1 iff a family
    fires."""
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""
        import threading

        class Plane:
            def start(self):
                self._t = threading.Thread(target=self._serve)
                self._t.start()

            def _serve(self):
                self.handle_one()
        """))
    assert lint_main(["--fail", str(bad)]) == 1
    out = capsys.readouterr().out
    assert "thread roles" in out and "finding(s)" in out

    good = tmp_path / "good.py"
    good.write_text(textwrap.dedent("""
        import threading

        class Plane:
            def start(self):
                self._t = threading.Thread(target=self._serve)
                self._t.start()

            def _serve(self):
                try:
                    self.handle_one()
                except Exception:
                    self.contained_crashes += 1
        """))
    assert lint_main(["--fail", str(good)]) == 0
    out = capsys.readouterr().out
    assert "[contained]" in out and "findings: none" in out


def _run_json(argv, capsys):
    import json

    rc = lint_main(argv)
    doc = json.loads(capsys.readouterr().out)
    assert doc["schema"] == 1
    assert isinstance(doc["findings"], list)
    assert isinstance(doc["errors"], list)
    return rc, doc


def test_json_default_mode(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""
        import threading

        class Stats:
            def __init__(self):
                self._lock = threading.Lock()
                self.rows = 0

            def bump(self, n):
                with self._lock:
                    self.rows += n

            def snapshot(self):
                with self._lock:
                    return {"rows": self.rows}

            def fast_path(self, n):
                self.rows += n
        """))
    rc, doc = _run_json(["--json", str(bad)], capsys)
    assert rc == 1 and doc["mode"] == "findings"
    assert any(f["rule"] == "unguarded-shared-write" for f in doc["findings"])
    f = doc["findings"][0]
    assert set(f) == {"file", "line", "col", "rule", "message", "suppressed"}


def test_json_locks_mode(tmp_path, capsys):
    src = tmp_path / "locks.py"
    src.write_text("x = 1\n")
    rc, doc = _run_json(["--locks", "--json", str(src)], capsys)
    assert rc == 0 and doc["mode"] == "locks"
    assert {"functions", "nodes", "edges", "cycles"} <= set(doc)


def test_json_wire_mode(tmp_path, capsys):
    src = tmp_path / "wire.py"
    src.write_text("x = 1\n")
    rc, doc = _run_json(["--wire", "--json", str(src)], capsys)
    assert rc == 0 and doc["mode"] == "wire"
    assert {"functions", "modules", "magics", "flags"} <= set(doc)


@pytest.mark.failflow
def test_json_fail_mode(tmp_path, capsys):
    src = tmp_path / "fail.py"
    src.write_text(textwrap.dedent("""
        import threading

        class Plane:
            def start(self):
                self._t = threading.Thread(target=self._serve)
                self._t.start()

            def _serve(self):
                self.handle_one()
        """))
    rc, doc = _run_json(["--fail", "--json", str(src)], capsys)
    assert rc == 1 and doc["mode"] == "fail"
    assert {"threads", "spans", "ledger", "handlers"} <= set(doc)
    assert doc["threads"] and doc["threads"][0]["status"] == "escapes"


# ------------------------------------------- call resolution (the port) ---
#
# The port's names collide with builtins and library functions: its
# DeviceStager.next, RunLogger.log, the fleet's run methods and the fused
# chunks' ``uniform`` closures. Resolved by bare name, as the reference
# resolves them, ``next(it)``, ``subprocess.run``, ``torch.log`` and
# ``rng.uniform`` bound to them and closed 20 false lock cycles over the
# package. The reference fires on each fixture below; the port does not.

_NEXT_BUILTIN = """
    class Stager:
        def next(self):
            with self._buffer_lock:
                return 1

    class Ring:
        def push(self, it):
            with self._ring_locks[0]:
                return next(it)
    """

_MODULE_CALLS = """
    import subprocess

    import torch

    class Harness:
        def run(self):
            with self._buffer_lock:
                return 1

    class RunLogger:
        def log(self, series, value):
            with self._buffer_lock:
                return value

    class Builder:
        def build(self, q):
            with self._ring_locks[0]:
                subprocess.run(["nvcc", "--version"])
                return torch.log(q)
    """

_CLOSURE_ATTR = """
    def make_chunk(buf):
        def uniform(n):
            with buf._buffer_lock:
                return n
        return uniform

    class Dealer:
        def draw(self, rng):
            with self._sampler_lock:
                return rng.uniform(0.0, 1.0)
    """

RESOLUTION_FIXTURES = {
    "next_builtin": _NEXT_BUILTIN,
    "module_calls": _MODULE_CALLS,
    "closure_attr": _CLOSURE_ATTR,
}


@pytest.mark.parametrize("name", sorted(RESOLUTION_FIXTURES))
def test_resolution_binds_no_builtin_module_or_closure_call(name):
    src = textwrap.dedent(RESOLUTION_FIXTURES[name])
    ref = reference_lint_source(src, "fixture.py", rules=["lock-cycle"])
    assert ref.findings, "the reference binds the call and fires"
    assert findings(src, "lock-cycle") == []


def test_resolution_keeps_a_real_abba_through_run():
    """``run`` stays resolvable: a real ABBA through a program's
    ``loop.run()`` fires (only the named builtin, module and closure
    calls stopped binding)."""
    out = findings("""
        import subprocess

        class Loop:
            def run(self):
                with self._commit_cond:
                    return 1

        class Service:
            def tick(self, loop, it):
                with self._buffer_lock:
                    subprocess.run(["true"])
                    next(it)
                    loop.run()

            def commit(self):
                with self._commit_cond:
                    with self._buffer_lock:
                        pass
        """, "lock-cycle")
    assert len(out) == 1
    assert "_buffer_lock" in out[0].message
    assert "_commit_cond" in out[0].message


def test_resolution_keeps_a_builtin_name_the_module_defines():
    """A module that defines its own ``next`` calls it, not the builtin."""
    out = findings("""
        def next(stager):
            with stager._buffer_lock:
                return 1

        class Ring:
            def push(self, stager):
                with self._ring_locks[0]:
                    return next(stager)
        """, "lock-cycle")
    assert len(out) == 1
    assert "'_buffer_lock'" in out[0].message


def test_resolution_binds_a_module_call_to_that_modules_functions(tmp_path):
    """A call on an imported module binds to that module's top-level
    functions when the module is part of the program, and to nothing
    else of that name."""
    pkg = tmp_path / "plane"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "helpers.py").write_text(textwrap.dedent("""
        def take(svc):
            with svc._buffer_lock:
                return 1
        """))
    (pkg / "other.py").write_text(textwrap.dedent("""
        class Other:
            def settle(self):
                with self._commit_cond:
                    return 1
        """))
    (pkg / "ring.py").write_text(textwrap.dedent("""
        import plane.helpers as helpers
        import plane.other

        class Ring:
            def push(self, svc):
                with self._ring_locks[0]:
                    helpers.take(svc)
                    plane.other.settle()
        """))
    res = lint_paths([str(pkg)], rules=["lock-cycle"])
    assert len(res.findings) == 1, [f.format() for f in res.findings]
    msg = res.findings[0].message
    assert "'_buffer_lock'" in msg and "_commit_cond" not in msg


# --------------------------------------------------- the port's registry --

def test_wire_registry_module_is_the_ports(tmp_path):
    """The port's ``core/wire.py`` is the one module that may declare the
    magics (the reference's pass knows only its own, and flags all nine
    declarations of the port's registry); a copy anywhere else is a
    private re-declaration."""
    src = textwrap.dedent("""
        import struct

        MAGIC_INGEST_V1 = 0xD4F6

        def encode(payload):
            return struct.pack("!II", MAGIC_INGEST_V1, len(payload))
        """)
    core = tmp_path / "d4pg_tpu_torch" / "core"
    core.mkdir(parents=True)
    (core / "wire.py").write_text(src)
    (tmp_path / "elsewhere.py").write_text(src)
    res = lint_paths([str(tmp_path)], rules=["wire-magic-registry"])
    assert [(Path(f.file).name, f.line) for f in res.findings] == [
        ("elsewhere.py", 4)]
    assert "d4pg_tpu_torch.core.wire" in res.findings[0].message


# -------------------------------------------------- parity with the ref --

# the port's own fixtures (call resolution, its registry's path): not the
# reference's, and held to their own assertions above
PORT_ONLY = ("test_resolution_", "test_wire_registry_module_is_the_ports")


def _fixture_sources() -> list:
    """(test name, source) for every fixture literal of the reference's
    tests in this file: the first argument of each ``findings(...)`` and
    ``textwrap.dedent(...)`` call."""
    tree = ast.parse(Path(__file__).read_text())
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or fn.name.startswith(
                PORT_ONLY):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call) and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and ast.unparse(node.func) in ("findings",
                                                   "textwrap.dedent")):
                out.append((fn.name, node.args[0].value))
    return out


FIXTURES = _fixture_sources()


def _sites(res) -> tuple:
    key = lambda f: (f.rule, f.line, f.col)  # noqa: E731
    return (sorted(key(f) for f in res.findings if f.rule in CARRIED),
            sorted(key(f) for f in res.suppressed if f.rule in CARRIED))


def test_parity_covers_every_fixture():
    """Every fixture-driven test of the reference's carried families
    contributes its sources (the suppression, CLI and JSON tests too)."""
    names = {name for name, _src in FIXTURES}
    assert len(FIXTURES) == 51 and len(names) == 48, (len(FIXTURES),
                                                      len(names))


@pytest.mark.parametrize("name,src", FIXTURES,
                         ids=[f"{n}-{i}" for i, (n, _s) in
                              enumerate(FIXTURES)])
def test_parity_with_reference(name, src):
    src = textwrap.dedent(src)
    port = lint_source(src, "fixture.py", rules=list(CARRIED))
    ref = reference_lint_source(src, "fixture.py", rules=list(CARRIED))
    assert port.errors == ref.errors
    assert _sites(port) == _sites(ref)
