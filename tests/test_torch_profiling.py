"""Port vs reference: the runtime sentinels
(``d4pg_tpu_torch/io/profiling.py``: ``RecompileSentinel``,
``TransferSentinel``, ``ReshardSentinel``) and the steady-state
invariants they hold on the port's hot paths, on the CPU.

Each test is the counterpart of a reference test, named in its
docstring. The sentinels' own behaviour comes first: on the CPU the
``meta`` device is the far side of a host/device crossing (it holds no
values, so a copy out of it or a read of it raises, and the sentinel has
already counted it when it was issued). Then a real reshard under two
gloo ranks. Then the four path invariants at small size (the ingest
overlap, the device dealer, the update loop, the fused chunk), each run
beside its reference twin under the reference's sentinels so that both
sides are shown to bracket the same work. On the CPU host and device are
one, so the port's transfer counts there are 0 by construction; the
transfer bars proper (bytes per path, no sync under
``guard="disallow"``) are held on the card by ``chip_smoke.py`` phase 29.
"""

import stat
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ranks
from torch.utils._python_dispatch import _get_current_dispatch_mode

from d4pg_tpu.distributed.replay_service import ReplayService as JaxService
from d4pg_tpu.io import profiling as jprof
from d4pg_tpu.learner import D4PGConfig as JaxConfig
from d4pg_tpu.learner import init_state as jax_init_state
from d4pg_tpu.learner import make_update as jax_make_update
from d4pg_tpu.learner.fused import make_fused_chunk as jax_fused_chunk
from d4pg_tpu.learner.pipeline import IngestOverlap as JaxOverlap
from d4pg_tpu.replay import device_per as jdper
from d4pg_tpu.replay.device_sampler import DeviceSampleDealer as JaxDealer
from d4pg_tpu.replay.fused_buffer import FusedDeviceReplay as JaxReplay
from d4pg_tpu.replay.schedule import SharedBetaSchedule as JaxBeta
from d4pg_tpu.replay.staging import DealtBlockRing as JaxRing
from d4pg_tpu.replay.uniform import TransitionBatch as JaxBatch
from d4pg_tpu_torch.distributed.replay_service import ReplayService
from d4pg_tpu_torch.io.from_jax import state_from_jax
from d4pg_tpu_torch.io.profiling import (
    RecompileError,
    RecompileSentinel,
    ReshardError,
    ReshardSentinel,
    StepTimer,
    TransferSentinel,
    classify,
    record_build,
)
from d4pg_tpu_torch.learner.fused import make_fused_chunk
from d4pg_tpu_torch.learner.pipeline import IngestOverlap
from d4pg_tpu_torch.learner.state import D4PGConfig, init_state
from d4pg_tpu_torch.learner.update import update_step
from d4pg_tpu_torch.obs.registry import REGISTRY
from d4pg_tpu_torch.ops import autotune as at
from d4pg_tpu_torch.ops import kernels
from d4pg_tpu_torch.parallel import spawn_local
from d4pg_tpu_torch.replay.device_sampler import DeviceSampleDealer
from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
from d4pg_tpu_torch.replay.schedule import SharedBetaSchedule
from d4pg_tpu_torch.replay.staging import DealtBlockRing
from d4pg_tpu_torch.replay.uniform import TransitionBatch

pytestmark = pytest.mark.torchport

OBS, ACT = 5, 2
DIMS = dict(obs_dim=OBS, act_dim=ACT, v_min=-10.0, v_max=10.0, n_atoms=11,
            hidden=(16, 16))


def _rows(rng, n, obs=OBS, act=ACT):
    done = (rng.random(n) < 0.2).astype(np.float32)
    return dict(
        obs=rng.standard_normal((n, obs)).astype(np.float32),
        action=rng.uniform(-1, 1, (n, act)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.standard_normal((n, obs)).astype(np.float32),
        done=done,
        discount=(0.99 * (1.0 - done)).astype(np.float32),
    )


def _counter(name: str) -> int:
    return REGISTRY.counter(name).value


# --------------------------------------------------- RecompileSentinel


def test_recompile_sentinel_trips_on_fresh_autotuner_keys():
    """Counterpart of ``test_profiling.py::
    test_recompile_sentinel_trips_on_shape_churn``: a timing run at a
    fresh shape is the port's steady-state stall (fault F1 was a cache
    key that always missed); each one fires, and ``assert_clean`` names
    them."""
    with RecompileSentinel() as sentinel:
        at.autotune_projection(4, -1.0, 1.0, 5, repeats=1, iters=1,
                               device="cpu")
        at.autotune_sampler(16, 2, 4, repeats=1, iters=1, device="cpu")
    assert sentinel.compilations == 2
    assert sentinel.events[0].startswith("autotune_projection [4, 5]")
    assert sentinel.events[1].startswith("autotune_sampler [8] over 16")
    with pytest.raises(RecompileError, match="2 compilation.*"
                       "autotune_projection"):
        sentinel.assert_clean("shape-churn loop")


def test_recompile_sentinel_clean_on_cached_decisions():
    """Counterpart of ``test_profiling.py::
    test_recompile_sentinel_clean_on_stable_loop``: once a decision is
    cached, asking again records nothing."""
    kw = dict(batch_size=8, v_min=-1.0, v_max=1.0, n_atoms=7, device="cpu")
    at.select_projection("auto", **kw)  # warm-up
    at.select_sampler("auto", capacity=32, k=2, batch_size=4, device="cpu")
    with RecompileSentinel() as sentinel:
        for _ in range(10):
            assert at.select_projection("auto", **kw).selected == "einsum"
            at.select_sampler("auto", capacity=32, k=2, batch_size=4,
                              device="cpu")
    sentinel.assert_clean()
    assert sentinel.compilations == 0 and sentinel.events == []


def test_recompile_sentinel_counts_a_kernel_build_not_a_reuse(
        tmp_path, monkeypatch):
    """Counterpart of the same pair for the kernel library: ``build`` of a
    source set with no library compiles (an nvcc stand-in writes each
    ``-o`` file) and fires once; the next ``build`` reuses the library and
    fires nothing."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'wb').close()\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    with RecompileSentinel() as fresh:
        path, _, _ = kernels.build()
    assert path.exists() and path.parent == tmp_path / "build"
    assert fresh.compilations == 1
    assert fresh.events == [f"kernels.build {path.name}"]
    with RecompileSentinel() as reuse:
        assert kernels.build()[1] == 0.0
    reuse.assert_clean("kernel library reuse")


def test_recompile_sentinel_ignores_outside_region():
    """Counterpart of ``test_profiling.py::
    test_recompile_sentinel_ignores_outside_region``: events before the
    bracket and after it do not count."""
    record_build("before")
    with RecompileSentinel() as sentinel:
        pass
    record_build("after")
    at.autotune_projection(4, -1.0, 1.0, 3, repeats=1, iters=1,
                           device="cpu")
    assert sentinel.compilations == 0
    sentinel.assert_clean()


# --------------------------------------------------- TransferSentinel


def test_transfer_sentinel_counts_and_classifies():
    """Counterpart of ``test_profiling.py::
    test_transfer_sentinel_counts_and_restores``, beside the reference's
    count of the same puts and get: the reference counts calls, the port
    counts operators and their bytes. ``meta`` is the far side."""
    with jprof.TransferSentinel() as ref:
        x = jax.device_put(np.ones(8, np.float32))
        jax.device_get(x)
        jax.device_put(np.zeros(2))
    assert (ref.h2d, ref.d2h, ref.total) == (2, 1, 3)

    host8, host2 = torch.ones(8), torch.zeros(2, dtype=torch.float64)
    with TransferSentinel() as t:
        far = host8.to("meta")
        host2.to("meta")
        with pytest.raises(NotImplementedError):
            far.cpu()  # counted when issued: meta holds no values
    assert (t.h2d, t.d2h, t.total) == (2, 1, 3)
    assert (t.h2d_bytes, t.d2h_bytes) == (32 + 16, 32)

    with TransferSentinel() as t:
        torch.empty(8, device="meta").copy_(host8)  # a copy into the card
        torch.empty(8, device="meta")[torch.tensor([0, 3])]  # host indices
        torch.empty(8, device="meta") * torch.tensor(2.0)  # a scalar: no
        torch.empty(8, device="meta").sum() * 2  # card work: no
        host8 * 3  # host work: no
        with pytest.raises(RuntimeError):
            torch.empty((), device="meta").item()
        with pytest.raises(RuntimeError):
            torch.empty(3, device="meta").equal(torch.empty(3, device="meta"))
    assert [(d, op.split(".")[1], n) for d, op, n in t.crossings] == [
        ("h2d", "copy_", 32), ("h2d", "index", 16),
        ("d2h", "_local_scalar_dense", 4), ("d2h", "equal", 1)]
    assert (t.h2d, t.h2d_bytes, t.d2h, t.d2h_bytes) == (2, 48, 2, 5)


def test_transfer_sentinel_zero_for_on_device_work():
    """Counterpart of ``test_profiling.py::
    test_transfer_sentinel_zero_for_on_device_work``."""
    x = torch.ones(8).to("meta")
    with TransferSentinel() as t:
        y = x * 2
        y = (y + x).relu()
        torch.full((3,), 1.5, device="meta")
    assert t.total == 0 and t.crossings == []


def test_transfer_sentinel_pops_its_mode_even_after_an_exception():
    """The mode is popped and the guard restored on exit, as the
    reference restores ``jax.device_put``/``device_get``: also when the
    bracket raises. The guard is inert on the CPU."""
    assert _get_current_dispatch_mode() is None
    with pytest.raises(ValueError, match="inside"):
        with TransferSentinel(guard="disallow") as t:
            torch.ones(2).to("meta")
            raise ValueError("inside")
    assert _get_current_dispatch_mode() is None
    assert t.h2d == 1
    with ReshardSentinel():
        pass
    assert _get_current_dispatch_mode() is None
    with pytest.raises(ValueError, match="transfer guard"):
        TransferSentinel(guard="sometimes")


def test_sentinels_publish_the_bracketed_counts_to_the_registry():
    """The registry counters (``profiling.recompiles``,
    ``explicit_h2d``, ``explicit_d2h``, ``reshards``: the reference's
    names) move by exactly what each bracket counted."""
    names = ("profiling.recompiles", "profiling.explicit_h2d",
             "profiling.explicit_d2h", "profiling.reshards")
    before = {n: _counter(n) for n in names}
    with RecompileSentinel():
        record_build("a")
        record_build("b")
    with TransferSentinel():
        far = torch.ones(4).to("meta")
        torch.ones(2).to("meta")
        torch.ones(1).to("meta")
        with pytest.raises(NotImplementedError):
            far.cpu()
    ReshardSentinel().inspect_text("c10d::send c10d::allreduce_")
    after = {n: _counter(n) - before[n] for n in names}
    assert after == {"profiling.recompiles": 2, "profiling.explicit_h2d": 3,
                     "profiling.explicit_d2h": 1, "profiling.reshards": 1}


def test_step_timer_rate():
    """Counterpart of ``test_profiling.py::test_step_timer_rate``."""
    timer = StepTimer(alpha=0.5)
    assert timer.stop(10) is None  # stop without start: no measurement
    timer.start()
    rate = timer.stop(100)
    assert rate is not None and rate > 0


# --------------------------------------------------- ReshardSentinel


def test_reshard_sentinel_counts_reshard_ops_only():
    """Counterpart of ``test_meshgraph.py::
    test_reshard_sentinel_counts_reshard_ops_only``, on a profiler-style
    event table: the all-reduce and all-gather are data parallelism, the
    backends' own spans (``gloo:``) are not operators."""
    before = _counter("profiling.reshards")
    table = "\n".join([
        "c10d::allreduce_        12.1us",  # expected: gradient reduction
        "c10d::allgather_         8.0us",  # expected: merge broadcast
        "c10d::alltoall_base_    31.0us",  # reshard: layout move
        "gloo:all_to_all         30.2us",  # the backend's span of it
        "c10d::send               4.4us",  # reshard: the permute
        "c10d::alltoall_         17.5us",
    ])
    sentinel = ReshardSentinel()
    assert sentinel.inspect_text(table) == 3
    assert sentinel.steady_state_reshards == 3
    assert sentinel.ops == {"all-to-all": 2, "collective-permute": 1}
    assert _counter("profiling.reshards") == before + 3
    with pytest.raises(ReshardError, match="all-to-all x2, "
                       "collective-permute x1"):
        sentinel.assert_clean("fixture path")


def test_reshard_sentinel_clean_and_publishes_counter():
    """Counterpart of ``test_meshgraph.py::
    test_reshard_sentinel_clean_and_publishes_counter``. ``inspect`` runs
    the function once (eager PyTorch has nothing to lower)."""
    before = _counter("profiling.reshards")
    calls = []

    def f(x):
        calls.append(1)
        return (x * 2.0).sum()

    sentinel = ReshardSentinel()
    assert sentinel.inspect(f, torch.ones(16)) == 0
    sentinel.assert_clean()
    assert calls == [1] and sentinel.ops == {}
    assert _counter("profiling.reshards") == before


def test_a_copy_between_two_cards_is_a_reshard_and_within_one_is_not():
    """The implicit reshard, classified from the arguments alone (before
    the operator runs, so the CPU can name a second card): a copy to
    another accelerator is a ``device-copy``; to the same one (``cuda``
    is the current ``cuda:i``) it is nothing; to the host a ``d2h``."""
    to_copy = torch.ops.aten._to_copy.default
    src = torch.empty(4, device="meta")
    card1 = torch.device("cuda", 1)
    assert classify(to_copy, (src,), {"device": card1}) == (
        "device-copy", 16)
    assert classify(to_copy, (src,), {"device": torch.device("meta")}) \
        is None
    assert classify(to_copy, (src,), {"device": torch.device("cpu")}) == (
        "d2h", 16)
    copy_ = torch.ops.aten.copy_.default
    assert classify(copy_, (src, torch.empty(4, device="meta")), {}) is None
    assert classify(copy_, (src, torch.ones(4)), {}) == ("h2d", 16)


def test_fused_learner_path_has_zero_reshards(rng):
    """Counterpart of ``test_meshgraph.py::
    test_fused_learner_path_has_zero_reshards``, beside the reference's
    HLO scan of its own fused chunk at the same shape."""
    cap = 64
    rows = _rows(rng, cap, obs=4)
    jcfg = JaxConfig(obs_dim=4, act_dim=2, v_min=-10, v_max=10, n_atoms=11,
                     hidden=(16, 16, 16))
    jstate = jax_init_state(jcfg, jax.random.key(0))
    storage = JaxBatch(**{k: jnp.asarray(v) for k, v in rows.items()})
    trees = jdper.insert(jdper.init(cap), jnp.arange(cap), 0.6)
    jfn = jax_fused_chunk(jcfg, k=2, batch_size=8, prioritized=True,
                          alpha=0.6, donate=False)
    ref = jprof.ReshardSentinel()
    ref.inspect(jfn, jstate, trees, storage, cap)
    ref.assert_clean("reference fused learner path")

    for arm in ("pallas", "pallas_ce"):
        cfg = D4PGConfig(obs_dim=4, act_dim=2, v_min=-10, v_max=10,
                         n_atoms=11, hidden=(16, 16, 16), projection=arm)
        buf = FusedDeviceReplay(cap, 4, 2, device="cpu", block_rows=32)
        buf.add(TransitionBatch(**rows))
        buf.drain()
        state = init_state(cfg, seed=0, device="cpu")
        fn = make_fused_chunk(cfg, k=2, batch_size=8)
        gen = torch.Generator().manual_seed(0)
        sentinel = ReshardSentinel()
        sentinel.inspect(fn, state, buf.trees, buf.storage, buf.size,
                         generator=gen)
        sentinel.assert_clean(f"fused learner path ({arm})")
        assert sentinel.steady_state_reshards == ref.reshards == 0
        assert sentinel.ops == {} and state.step == 2


def test_gloo_alltoall_and_send_recv_reshard_and_allreduce_does_not(rng):
    """A real reshard under two gloo ranks (``tests/torch_ranks.py::
    reshard_probe``): an ``all_to_all_single`` and a send/recv exchange
    count as reshards on each rank (the permute's ``send`` and ``recv``
    apart); the sharded update's gradient ``all_reduce`` and the sharded
    fused chunk's (gradients and the IS normalizer) are tallied in ``ops``
    only: 0 reshards, as the reference's HLO holds only all-reduces for
    its data-parallel update. No build and, on the CPU, no crossing."""
    kw = dict(obs_dim=4, act_dim=2, v_min=-5.0, v_max=5.0, n_atoms=11,
              hidden=(16, 16), projection="einsum")
    cfg = D4PGConfig(**kw)
    payload = torch_ranks.pack_state(init_state(cfg, seed=3, device="cpu"))
    fields = _rows(rng, 16, obs=4)
    w = rng.uniform(0.2, 1.0, 16).astype(np.float32)
    blocks = [[_rows(rng, 32, obs=4)] for _ in range(2)]
    outs = spawn_local(torch_ranks.reshard_probe, 2,
                       args=(cfg, payload, fields, w, 64, blocks, 2, 8))
    for r, out in enumerate(outs):
        probe = out["probe"]
        assert probe["ops"] == {"all-to-all": 1, "collective-permute": 2}
        assert probe["reshards"] == 3
        # the all-to-all moved rank i's half j to rank j
        np.testing.assert_array_equal(
            probe["moved"],
            np.array([2 * r, 2 * r + 1, 10 + 2 * r, 11 + 2 * r], np.float32))
        np.testing.assert_array_equal(
            probe["got"], np.arange(4, dtype=np.float32) + 10 * (1 - r))
        for tag in ("update", "chunk"):
            got = out[tag]
            assert got["reshards"] == 0, (tag, got)
            assert set(got["ops"]) == {"all-reduce"}, (tag, got)
            assert got["compilations"] == 0 and got["transfers"] == 0
        # one flat gradient average per backward (critic, actor), then
        # the scalar metrics' average
        assert out["update"]["ops"]["all-reduce"] == 3
        # per grad step the IS normalizer and the two gradient averages;
        # the metrics' average once per chunk (K = 2)
        assert out["chunk"]["ops"]["all-reduce"] == 3 * 2 + 1


# --------------------------------------------------- path invariants


def test_overlap_le_one_block_per_chunk(rng):
    """Counterpart of ``test_ingest.py::test_overlap_le_one_h2d_per_chunk``
    (the shipped schedule: commit, chunk, add, stage). The reference
    counts at most one ``device_put`` per chunk; the port stages the same
    rows (its ledger equals the reference's), with 0 compilations and 0
    reshards, and on the card one copy per field per staged block, of
    rows staged x row bytes (phase 29). On the CPU there is no
    host/device line: its transfer count is 0 by construction."""
    jcfg = JaxConfig(**DIMS)
    jbuf = JaxReplay(256, OBS, ACT, alpha=0.6, block_rows=32)
    jsvc = JaxService(jbuf)
    jingest = JaxOverlap(jsvc)
    jfn = jax_fused_chunk(jcfg, k=2, batch_size=8, alpha=0.6, donate=True)
    jstate = jax_init_state(jcfg, jax.random.key(0))
    cfg = D4PGConfig(**DIMS, projection="pallas")
    buf = FusedDeviceReplay(256, OBS, ACT, alpha=0.6, block_rows=32,
                            device="cpu")
    svc = ReplayService(buf)
    ingest = IngestOverlap(svc)
    fn = make_fused_chunk(cfg, k=2, batch_size=8, alpha=0.6)
    state = init_state(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    first = _rows(rng, 64)
    feeds = [_rows(rng, 32) for _ in range(6)]
    n_chunks = len(feeds)
    try:
        for s, batch in ((jsvc, JaxBatch), (svc, TransitionBatch)):
            s.add(batch(**first))
            s.flush()
        jingest.flush()
        ingest.flush()
        jstate, jbuf.trees, m = jfn(jstate, jbuf.trees, jbuf.storage,
                                    jbuf.size)  # warm-up/compile
        buf.trees, _ = fn(state, buf.trees, buf.storage, buf.size,
                          generator=gen)  # warm-up
        with jprof.TransferSentinel() as jt:
            for rows in feeds:
                jingest.commit()
                jstate, jbuf.trees, m = jfn(jstate, jbuf.trees,
                                            jbuf.storage, jbuf.size)
                jsvc.add(JaxBatch(**rows))
                jsvc.flush()
                jingest.stage()
        with RecompileSentinel() as rec, TransferSentinel() as tr, \
                ReshardSentinel() as resh:
            for rows in feeds:
                ingest.commit()
                buf.trees, _ = fn(state, buf.trees, buf.storage, buf.size,
                                  generator=gen)
                svc.add(TransitionBatch(**rows))
                svc.flush()
                ingest.stage()
        assert jt.h2d <= n_chunks
        rec.assert_clean("ingest overlap steady state")
        resh.assert_clean("ingest overlap steady state")
        assert tr.total == 0 and tr.h2d_bytes == 0  # no host/device line
        for name in ("rows_staged", "rows_committed", "blocks"):
            assert getattr(ingest, name) == getattr(jingest, name), name
        # every staged row is committed or still in flight
        assert ingest.rows_staged == (ingest.rows_committed - 64) + 32
        assert ingest.rows_staged == n_chunks * 32
        ingest.flush()
        jingest.flush()
        assert len(buf) == len(jbuf) == 64 + n_chunks * 32
    finally:
        svc.close()
        jsvc.close()


def test_update_loop_is_steady_state(rng):
    """Counterpart of ``test_learner.py::test_update_loop_is_steady_state``
    beside the reference's own loop: after warm-up, repeated updates with
    fresh batch values build, load or tune nothing."""
    kw = dict(obs_dim=3, act_dim=1, v_min=-10.0, v_max=10.0, n_atoms=11,
              hidden=(32, 32))
    jcfg = JaxConfig(**kw)
    update = jax_make_update(jcfg, donate=False)
    js = jax_init_state(jcfg, jax.random.key(0))
    cfg = D4PGConfig(**kw, projection="pallas_ce")
    state = state_from_jax(cfg, jax.tree_util.tree_map(
        np.asarray, js._replace(key=jax.random.key_data(js.key))), "cpu")
    batches = [_rows(np.random.default_rng(i), 32, obs=3, act=1)
               for i in range(4)]
    js, _ = update(js, JaxBatch(**batches[0]), jnp.ones(32))  # warm-up
    update_step(cfg, state, TransitionBatch(
        **{k: torch.from_numpy(v) for k, v in batches[0].items()}),
        torch.ones(32))
    with jprof.RecompileSentinel() as jrec:
        for rows in batches[1:]:
            js, jm = update(js, JaxBatch(**rows), jnp.ones(32))
        jax.block_until_ready(jm["critic_loss"])
    jrec.assert_clean("reference update loop")
    with RecompileSentinel() as rec, ReshardSentinel() as resh:
        for rows in batches[1:]:
            m = update_step(cfg, state, TransitionBatch(
                **{k: torch.from_numpy(v) for k, v in rows.items()}),
                torch.ones(32))
    rec.assert_clean("learner update loop")
    resh.assert_clean("learner update loop")
    assert state.step == 4
    np.testing.assert_allclose(m["critic_loss"].numpy(),
                               np.asarray(jm["critic_loss"]), rtol=1e-4)


CAP, K, B, OD, AD = 128, 2, 8, 4, 2


def _mk_batch(rng, n, batch):
    return batch(**_rows(rng, n, obs=OD, act=AD))


def test_deal_dispatch_sentinels(rng):
    """Counterpart of ``test_devsample.py::test_deal_dispatch_sentinels``,
    beside the reference's rig: after warm-up the ingest+deal loop makes
    no compilation and no reshard in the deal dispatch. The reference
    counts at most one ``device_put`` per tick (the staged frames); the
    port's only host-to-device bytes on the card are the staged frames and
    the K x B float32 uniforms of each deal (phase 29), and on the CPU
    none."""
    jbuf = JaxReplay(CAP, OD, AD, alpha=0.6, gen_tracked=True, block_rows=32)
    jring = JaxRing(4)
    jdealer = JaxDealer(CAP, [jring], k=K, batch_size=B, alpha=0.6,
                        beta_schedule=JaxBeta(), min_size=8, seed=42)
    jdealer.resync(jbuf)
    buf = FusedDeviceReplay(CAP, OD, AD, alpha=0.6, device="cpu",
                            gen_tracked=True, block_rows=32)
    ring = DealtBlockRing(4)
    dealer = DeviceSampleDealer(CAP, [ring], k=K, batch_size=B, alpha=0.6,
                                beta_schedule=SharedBetaSchedule(),
                                min_size=8, seed=42, arm="pallas")
    dealer.resync(buf)
    feed = _rows(rng, 16, obs=OD, act=AD)
    rounds = 6
    for b, rg, d, batch in ((jbuf, jring, jdealer, JaxBatch),
                            (buf, ring, dealer, TransitionBatch)):
        d.publish(d.ingest_and_deal([(b.add(batch(**feed)), None, None)],
                                    b))  # warm-up
        while rg.pop(timeout=0) is not None:
            pass
    with jprof.RecompileSentinel() as jrec, jprof.TransferSentinel() as jtr:
        for _ in range(rounds):
            jdealer.publish(jdealer.ingest_and_deal(
                [(jbuf.add(JaxBatch(**feed)), None, None)], jbuf))
            while jring.pop(timeout=0) is not None:
                pass
        jax.block_until_ready(jbuf.trees.sum_tree)
    jrec.assert_clean("reference device ingest+deal steady state")
    assert jtr.h2d <= rounds
    dealt = []
    with RecompileSentinel() as rec, TransferSentinel() as tr:
        for _ in range(rounds):
            dealer.publish(dealer.ingest_and_deal(
                [(buf.add(TransitionBatch(**feed)), None, None)], buf))
            while (blk := ring.pop(timeout=0)) is not None:
                dealt.append(blk)
    rec.assert_clean("device ingest+deal steady state")
    assert tr.total == 0 and tr.h2d_bytes == 0  # no host/device line
    assert len(dealt) == rounds == dealer.dealt_blocks - 1
    resh = ReshardSentinel()
    u = np.zeros((K, B), np.float32)
    resh.inspect(dealer.deal, buf, u, buf.size, 0.4)
    resh.assert_clean("device deal dispatch")
    assert resh.steady_state_reshards == 0


@pytest.mark.parametrize("arm", ["pallas", "pallas_ce"])
def test_fused_chunk_steady_state_sentinels(rng, arm):
    """Counterpart of ``bench.py::bench_fused``'s bracket (the reference
    times its windows under these sentinels): after one warm-up chunk,
    chunks under both projection arms make no compilation, no crossing
    and no reshard; the reference's chunk at the same shape makes no
    compilation and no explicit transfer."""
    cap = 128
    rows = _rows(rng, cap)
    jcfg = JaxConfig(**DIMS)
    jbuf = JaxReplay(cap, OBS, ACT, alpha=0.6, block_rows=64)
    jbuf.add(JaxBatch(**rows))
    jbuf.drain()
    jfn = jax_fused_chunk(jcfg, k=2, batch_size=8, alpha=0.6, donate=False)
    js = jax_init_state(jcfg, jax.random.key(0))
    js, jbuf.trees, _ = jfn(js, jbuf.trees, jbuf.storage, jbuf.size)
    with jprof.RecompileSentinel() as jrec, jprof.TransferSentinel() as jtr:
        for _ in range(3):
            js, jbuf.trees, jm = jfn(js, jbuf.trees, jbuf.storage,
                                     jbuf.size)
        jax.block_until_ready(jm["critic_loss"])
    jrec.assert_clean("reference fused chunk")
    assert jtr.total == 0

    cfg = D4PGConfig(**DIMS, projection=arm)
    buf = FusedDeviceReplay(cap, OBS, ACT, alpha=0.6, device="cpu",
                            block_rows=64)
    buf.add(TransitionBatch(**rows))
    buf.drain()
    fn = make_fused_chunk(cfg, k=2, batch_size=8, alpha=0.6)
    state = init_state(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    buf.trees, _ = fn(state, buf.trees, buf.storage, buf.size,
                      generator=gen)  # warm-up
    with RecompileSentinel() as rec, TransferSentinel(guard="disallow") \
            as tr, ReshardSentinel() as resh:
        for _ in range(3):
            buf.trees, m = fn(state, buf.trees, buf.storage, buf.size,
                              generator=gen)
    rec.assert_clean(f"fused chunk ({arm})")
    resh.assert_clean(f"fused chunk ({arm})")
    assert tr.total == 0 and tr.crossings == []
    assert state.step == 8 and bool(torch.isfinite(m["critic_loss"]).all())
