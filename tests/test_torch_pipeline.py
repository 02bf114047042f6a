"""Port vs reference: ``DeviceStager`` and ``ChunkPipeline``, the
host-sampled path's staging and K-chunk pipeline.

With a deterministic fake update, the port's and the reference's
pipelines must run the same schedule: the order of samples, updates and
priority write-backs (each chunk written back once, with its own td),
staleness within ``(depth + 1) * K`` grad steps, ``invalidate`` dropping
the staged chunk and ``final_prefetch`` leaving one staged. The stager
keeps order, carries the aux on the host and drops its in-flight sample
on ``invalidate``, as ``tests/test_staging.py`` pins for the reference.
Then two real chunks (K = 3, batch 16) sampled from a host PER buffer
through the port's ``multi_update_step`` against the reference's jitted
one over the same buffer: slots and IS weights bitwise, losses, TD
errors and the written-back tree leaves at the learner's bars (rtol
1e-5, atol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.learner import pipeline as jpipe
from d4pg_tpu.learner import state as jstate
from d4pg_tpu.learner.update import make_multi_update
from d4pg_tpu.replay import prioritized as jper
from d4pg_tpu.replay import staging as jstaging
from d4pg_tpu_torch.io.from_jax import state_from_jax
from d4pg_tpu_torch.learner import pipeline as tpipe
from d4pg_tpu_torch.learner import state as tstate
from d4pg_tpu_torch.learner.update import multi_update_step
from d4pg_tpu_torch.replay import prioritized as tper
from d4pg_tpu_torch.replay import staging as tstaging

pytestmark = pytest.mark.torchport

TOL = dict(rtol=1e-5, atol=1e-6)


def _counter_sample(log=None, with_aux=False):
    n = {"i": 0}

    def sample():
        i = n["i"]
        n["i"] += 1
        if log is not None:
            log.append(("sample", i))
        x = np.full((4,), float(i), np.float32)
        return (x, ("idx", i)) if with_aux else x

    return sample, n


@pytest.mark.parametrize("side", ["port", "reference"])
def test_stager_preserves_order_values_and_aux(side):
    sample, n = _counter_sample(with_aux=True)
    st = (tstaging.DeviceStager(sample, device="cpu")
          if side == "port" else jstaging.DeviceStager(sample, with_aux=True))
    for expect in range(5):
        got, aux = st.next()
        np.testing.assert_array_equal(np.asarray(got),
                                      np.full((4,), float(expect)))
        assert aux == ("idx", expect)
    assert n["i"] == 6  # one sample always in flight beyond the consumed
    st.invalidate()  # drops sample 5, staged in flight
    assert st.next()[1] == ("idx", 6)
    assert st.next(prefetch=False)[1] == ("idx", 7)
    assert n["i"] == 8
    if side == "port":
        assert isinstance(got, torch.Tensor)  # the payload is staged


def test_stager_stages_nested_payloads():
    """NamedTuples, tuples and None leaves keep their structure; tensor
    leaves pass through untouched."""
    passed = torch.arange(3)

    def sample():
        rows = tper.TransitionBatch(*[np.full((2,), float(i), np.float32)
                                      for i in range(6)])
        return (rows, None, passed), "aux"

    (rows, none, same), aux = tstaging.DeviceStager(
        sample, device="cpu").next()
    assert isinstance(rows, tper.TransitionBatch) and none is None
    assert same is passed and aux == "aux"
    assert [float(f[0]) for f in rows] == [0, 1, 2, 3, 4, 5]


def _fake_run(side, runs, k=4, depth=2):
    """Drive a pipeline with a fake update whose td is the chunk's index;
    returns the event log: samples, updates and write-backs in order."""
    log = []
    sample, n = _counter_sample(log)

    def chunk_sample():
        x = sample()
        return (x, np.ones(2, np.float32)), ("aux", int(x[0]))

    def update(state, batch, w):
        i = int(np.asarray(batch)[0])
        log.append(("update", i))
        td = np.full((k,), float(i), np.float32)
        return state + 1, {"td_error": (torch.from_numpy(td)
                                        if side == "port" else jnp.asarray(td))}

    def write_back(aux, prio):
        log.append(("write_back", aux[1], float(prio[0])))

    if side == "port":
        pipe = tpipe.ChunkPipeline(update, chunk_sample, write_back,
                                   device="cpu", depth=depth)
    else:
        pipe = jpipe.ChunkPipeline(update, chunk_sample, write_back,
                                   depth=depth)
    state = 0
    for n_chunks, final_prefetch, invalidate in runs:
        if invalidate:
            pipe.invalidate()
        state, _ = pipe.run(state, n_chunks, final_prefetch=final_prefetch)
    return log, state


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("runs", [
    [(8, True, False)],
    [(3, False, True), (3, False, True)],  # sync mode: invalidate per cycle
    [(2, True, False), (5, True, False)],  # async: the prefetch carries over
    [(1, True, True), (4, False, True), (2, True, False)],
])
def test_pipeline_schedule_matches_reference(runs, depth):
    port, port_state = _fake_run("port", runs, depth=depth)
    ref, ref_state = _fake_run("reference", runs, depth=depth)
    assert port == ref
    assert port_state == ref_state == sum(r[0] for r in runs)
    updates = [e[1] for e in port if e[0] == "update"]
    backs = [e for e in port if e[0] == "write_back"]
    # every dispatched chunk written back exactly once, in order, with
    # its own td (+ 1e-6)
    assert [b[1] for b in backs] == updates
    for _, i, prio in backs:
        assert prio == np.float32(i) + np.float32(1e-6)
    # staleness: chunks sampled before chunk t's priorities land
    for t, pos in ((e[1], j) for j, e in enumerate(port)
                   if e[0] == "write_back"):
        sampled = sum(1 for e in port[:pos] if e[0] == "sample")
        assert sampled - (t + 1) <= depth + 1


def test_pipeline_td_copy_waits_count_and_cpu_has_no_event():
    """On the CPU the td is read directly (no event, no waits)."""
    pipe = tpipe.ChunkPipeline(
        lambda s, b: (s, {"td_error": torch.ones(2)}),
        lambda: ((np.zeros(2, np.float32), None), ("aux",)),
        write_back=lambda aux, td: None, device="cpu", use_weights=False)
    pipe.run(0, 5)
    assert pipe.waits == 0 and pipe.stager.h2d_bytes == 0
    assert tpipe._start_fetch(None) is None
    td, event = tpipe._start_fetch(torch.arange(3.0))
    assert event is None and isinstance(td, np.ndarray)


DIMS = dict(obs_dim=3, act_dim=2, v_min=-10.0, v_max=10.0, n_atoms=11,
            hidden=(32, 32), projection="pallas")


@pytest.mark.parametrize("storage", ["host", "device"])
def test_real_chunks_match_reference(rng, storage):
    k, b, cap = 3, 16, 200
    jcfg = jstate.D4PGConfig(**DIMS)
    tcfg = tstate.D4PGConfig(**DIMS)
    js = jstate.init_state(jcfg, jax.random.key(4))
    ts = state_from_jax(tcfg, jax.tree_util.tree_map(
        np.asarray, js._replace(key=jax.random.key_data(js.key))), "cpu")
    jbuf = jper.PrioritizedReplayBuffer(cap, 3, 2, seed=9, backend="numpy")
    tbuf = tper.PrioritizedReplayBuffer(cap, 3, 2, seed=9, storage=storage,
                                        device="cpu")
    done = (rng.random(150) < 0.2).astype(np.float32)
    rows = dict(obs=rng.standard_normal((150, 3)).astype(np.float32),
                action=rng.uniform(-1, 1, (150, 2)).astype(np.float32),
                reward=rng.uniform(-12, 12, 150).astype(np.float32),
                next_obs=rng.standard_normal((150, 3)).astype(np.float32),
                done=done, discount=(0.99 ** 3 * (1 - done)).astype(
                    np.float32))
    jbuf.add(jper.TransitionBatch(**rows))
    tbuf.add(tper.TransitionBatch(**rows))

    samples = {"port": [], "reference": []}
    metrics = {"port": [], "reference": []}

    def sampler(buf, side):
        def sample():
            batches, w, idx = buf.sample_chunk(k, b, beta=0.4)
            samples[side].append((idx, w))
            return (batches, w), (idx, buf.generation[idx].copy())
        return sample

    def write_back(buf):
        def back(aux, td):
            idx, gen = aux
            for i in range(len(idx)):
                buf.update_priorities(idx[i], td[i], generation=gen[i])
        return back

    jupdate = make_multi_update(jcfg, donate=False)

    def jax_update(state, batches, w):
        state, m = jupdate(state, batches, w)
        metrics["reference"].append(m)
        return state, m

    def port_update(state, batches, w):
        m = multi_update_step(tcfg, state, batches, w)
        metrics["port"].append(m)
        return state, m

    jpipe.ChunkPipeline(jax_update, sampler(jbuf, "reference"),
                        write_back(jbuf)).run(js, 2, final_prefetch=False)
    tpipe.ChunkPipeline(port_update, sampler(tbuf, "port"),
                        write_back(tbuf), device="cpu").run(
                            ts, 2, final_prefetch=False)
    assert len(samples["port"]) == len(samples["reference"]) == 2
    for (ti, tw), (ji, jw) in zip(samples["port"], samples["reference"]):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tw, jw)
    for tm, jm in zip(metrics["port"], metrics["reference"]):
        for name in ("critic_loss", "actor_loss", "td_error"):
            np.testing.assert_allclose(tm[name].numpy(), np.asarray(jm[name]),
                                       err_msg=name, **TOL)
    live = np.arange(150)
    np.testing.assert_allclose(tbuf._trees.get(live), jbuf._trees.get(live),
                               **TOL)
    np.testing.assert_allclose(tbuf.max_priority, jbuf.max_priority, **TOL)
