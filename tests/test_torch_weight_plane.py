"""Port vs reference: the v2 weight plane (``distributed/weight_plane``).

The codecs (``f32_to_bf16``, ``bf16_to_f32``, ``quantize_int8``,
``encode_flat``, ``decode_flat``) and the delta (``delta_encode``,
``delta_apply``) give the reference's bytes on the same seeded numpy
inputs, odd byte lengths, the all-zero tensor, subnormals and infinities
included, and the quantization oracle holds. The torch
``WeightPlaneServer``'s frames are the reference server's bytes under one
pinned clock and trace id, full and delta, for each codec. Pullers
interoperate both ways (a reference client on a torch server, a torch
client on a reference server), full then delta, each reconstruction
bitwise the decoded full snapshot; a v1 client pulls from the plane
server; a relay chain runs torch -> reference -> torch. Then the
reference's ``tests/test_weight_plane.py`` cases against the port: the
out-of-window fallback to a full frame, torn payloads refused under
``WeightWireChaos``, the generation fence and window purge, the
single-flight memo, traces that never orphan, and v1 normalizer
statistics across a server restart. Every client has a connect timeout,
every pull loop a deadline, and every server closes in a ``finally``.
"""

import json
import time
from unittest import mock

import numpy as np
import pytest
import torch

from d4pg_tpu.distributed import weight_plane as jwp
from d4pg_tpu.distributed import weight_server as jws
from d4pg_tpu.distributed.weights import WeightStore as JaxStore
from d4pg_tpu_torch.distributed import weight_plane as twp
from d4pg_tpu_torch.distributed import weight_server as tws
from d4pg_tpu_torch.distributed.weights import WeightStore
from d4pg_tpu_torch.io.from_jax import flax_layout, torch_layout
from d4pg_tpu_torch.obs.trace import RECORDER

pytestmark = pytest.mark.torchport

FIXED_CLOCK = 1.7e9
PUB_TS = 1234.5


def _arrays(name: str) -> np.ndarray:
    """Seeded float32 inputs of every kind the codecs must agree on."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "normal":
        return (rng.normal(size=(33, 7)) * 10.0 ** rng.integers(
            -6, 6, size=(33, 7))).astype(np.float32)
    if name == "odd_length":
        return rng.normal(size=(5,)).astype(np.float32)
    if name == "zeros":
        return np.zeros((4, 3), np.float32)
    if name == "subnormal":
        tiny = np.float32(np.finfo(np.float32).tiny)
        return (rng.uniform(-1, 1, size=16) * tiny).astype(np.float32)
    if name == "inf":
        x = rng.normal(size=8).astype(np.float32)
        x[[1, 5]] = [np.inf, -np.inf]
        return x
    if name == "empty":
        return np.zeros((0, 3), np.float32)
    raise KeyError(name)


KINDS = ["normal", "odd_length", "zeros", "subnormal", "inf", "empty"]


def _same_bytes(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(
        np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        and np.asarray(a[k]).shape == np.asarray(b[k]).shape
        and np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes()
        for k in a)


# ------------------------------------------------------------ codecs ----

@pytest.mark.parametrize("kind", KINDS)
def test_bf16_bits_and_back_byte_equal(kind):
    x = _arrays(kind)
    ours, ref = twp.f32_to_bf16(x), jwp.f32_to_bf16(x)
    assert ours.dtype == ref.dtype == np.uint16
    assert ours.tobytes() == ref.tobytes()
    back = twp.bf16_to_f32(ours)
    assert back.tobytes() == jwp.bf16_to_f32(ref).tobytes()
    finite = np.isfinite(x)
    assert np.all(np.abs(back[finite] - x[finite]) <= twp.BF16_REL_BOUND
                  * np.abs(x[finite]) + twp.BF16_ABS_FUDGE)
    assert back[~finite].tobytes() == x[~finite].tobytes()


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_int8_byte_equal(kind):
    x = _arrays(kind)
    with np.errstate(all="ignore"):  # inf / inf at the inf case
        (q, scale), (rq, rscale) = twp.quantize_int8(x), jwp.quantize_int8(x)
    assert q.dtype == np.int8 and q.tobytes() == rq.tobytes()
    assert isinstance(scale, float) and np.float64(scale).tobytes() == \
        np.float64(rscale).tobytes()
    if kind == "zeros":
        assert scale == 1.0 and not q.any()


def _flat(seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    return {"a/w": _arrays("normal"), "a/b": rng.normal(size=(24,)).astype(
                np.float32),
            "a/odd": _arrays("odd_length"), "a/sub": _arrays("subnormal"),
            "a/zero": _arrays("zeros"), "a/i": np.arange(7, dtype=np.int32),
            "a/u8": np.arange(5, dtype=np.uint8),
            "__norm_mean__": rng.normal(size=(4,)),
            "__norm_clip__": np.float64(5.0)}


@pytest.mark.parametrize("codec", twp.CODECS)
def test_encode_decode_flat_byte_equal_and_within_bound(codec):
    flat = _flat()
    enc, ref = twp.encode_flat(flat, codec), jwp.encode_flat(flat, codec)
    assert _same_bytes(enc, ref)
    dec = twp.decode_flat(enc)
    assert _same_bytes(dec, jwp.decode_flat(ref))
    # metadata, normalizer keys and non-float32 tensors travel raw
    for k in ("a/i", "a/u8", "__norm_mean__", "__norm_clip__"):
        assert np.asarray(dec[k]).tobytes() == np.asarray(flat[k]).tobytes()
    assert twp.quant_error_excess(flat, enc) <= 0
    assert jwp.quant_error_excess(flat, ref) <= 0


def test_int8_oracle_counts_no_exact_half_step_as_a_failure():
    """A value whose quotient by the scale rounds to an exact half step
    is quantized to the even neighbour, half a step away give or take
    float32 rounding: the port's oracle holds it within the bound, where
    the reference's (float32 error against scale / 2 * (1 + 1e-6))
    reports a failure. The frames are the same bytes either way."""
    scale = np.float32(0.002170074408448587)
    x = np.array([0.03580623, -0.2755994498729706], np.float32)
    assert x[0] / scale == np.float32(16.5)  # the exact half
    flat = {"w": x}
    enc = twp.encode_flat(flat, "int8")
    assert _same_bytes(enc, jwp.encode_flat(flat, "int8"))
    assert enc["q:w"][0] == 16  # round half to even
    assert twp.quant_error_excess(flat, enc) <= 0
    assert jwp.quant_error_excess(flat, enc) > 0


def test_unknown_codec_and_prefix_refused():
    with pytest.raises(ValueError):
        twp.encode_flat({}, "fp4")
    with pytest.raises(ValueError):
        twp.WeightPlaneClient("127.0.0.1", 1, codec="fp4")
    with pytest.raises(twp.ProtocolError):
        twp.decode_flat({"z:x": np.zeros(2, np.float32)})


# ------------------------------------------------------------- delta ----

def _delta_case(case: str) -> tuple[dict, dict]:
    base = twp.encode_flat(_flat(), "f32")
    new = {k: np.array(v) for k, v in base.items()}
    if case == "sparse":
        new["r:a/w"][3, 2] += 1.0
    elif case == "dense":
        new["r:a/b"] = new["r:a/b"] + 1.0
    elif case == "same":
        pass
    elif case == "absent":
        new["r:a/new"] = np.ones(3, np.float32)
    elif case == "dropped":
        del new["r:a/i"]
    elif case == "reshaped":
        new["r:a/w"] = new["r:a/w"].reshape(7, 33)
    elif case == "odd_bytes":
        new["r:a/u8"] = new["r:a/u8"] + 1
        new["r:a/odd"][0] = 0.0
    elif case == "quantized":
        flat = _flat()
        flat["a/w"] = flat["a/w"].copy()
        flat["a/w"][0, 0] += 0.25
        base = twp.encode_flat(_flat(), "int8")
        new = twp.encode_flat(flat, "int8")
    return base, new


@pytest.mark.parametrize("case", ["sparse", "dense", "same", "absent",
                                  "dropped", "reshaped", "odd_bytes",
                                  "quantized"])
def test_delta_encode_apply_byte_equal(case):
    base, new = _delta_case(case)
    entries, ref = twp.delta_encode(base, new), jwp.delta_encode(base, new)
    assert _same_bytes(entries, ref)
    rebuilt = twp.delta_apply(base, entries)
    assert _same_bytes(rebuilt, jwp.delta_apply(base, ref))
    assert rebuilt.keys() == new.keys()
    assert all(rebuilt[k].tobytes() == np.asarray(new[k]).tobytes()
               and rebuilt[k].dtype == np.asarray(new[k]).dtype
               for k in new)
    if case == "sparse":
        assert "xi:r:a/w" in entries
    if case == "dropped":
        assert json.loads(entries["__dropped__"].tobytes()) == ["r:a/i"]


def test_delta_apply_refuses_unknown_base():
    base, new = _delta_case("sparse")
    entries = twp.delta_encode(base, new)
    with pytest.raises(twp.ProtocolError):
        twp.delta_apply({}, entries)


# ---------------------------------------------------- weights and frames ----

def _actor(seed: int = 0) -> dict[str, torch.Tensor]:
    """A small actor's state_dict (Dense layers and a LayerNorm)."""
    g = torch.Generator().manual_seed(seed)
    return {
        "fc1.weight": torch.randn(16, 6, generator=g),
        "fc1.bias": torch.randn(16, generator=g),
        "ln1.weight": torch.rand(16, generator=g) + 0.5,
        "ln1.bias": torch.randn(16, generator=g),
        "out.weight": torch.randn(3, 16, generator=g) * 1e-3,
        "out.bias": torch.zeros(3),
    }


def _step(params: dict, seed: int) -> dict:
    """The next version: one Dense kernel moves in a few entries, the
    LayerNorm's bias everywhere, the rest stays."""
    g = torch.Generator().manual_seed(seed)
    out = {k: v.clone() for k, v in params.items()}
    out["fc1.weight"][0, :3] += torch.randn(3, generator=g)
    out["ln1.bias"] += 0.01 * torch.randn(16, generator=g)
    return out


NORM = (np.linspace(-1, 1, 6), np.linspace(0.5, 2, 6), 3.5)


def _pinned(monkeypatch):
    for mod in (twp, jwp):
        monkeypatch.setattr(mod, "new_trace_id", lambda salt=0: 4242)


@pytest.mark.parametrize("codec", twp.CODECS)
@pytest.mark.parametrize("kind", ["full", "delta"])
def test_v2_frames_byte_equal_to_the_reference(monkeypatch, codec, kind):
    _pinned(monkeypatch)
    p1, p2 = _actor(1), _step(_actor(1), 2)
    store, jstore = WeightStore(), JaxStore()
    server, jserver = (twp.WeightPlaneServer(store),
                       jwp.WeightPlaneServer(jstore))
    try:
        for version, p in ((1, p1), (2, p2)):
            store.publish_versioned({k: v.clone() for k, v in p.items()},
                                    version, step=40 * version,
                                    norm_stats=NORM, publish_ts=PUB_TS)
            jstore.publish_versioned(flax_layout(p), version,
                                     step=40 * version, norm_stats=NORM,
                                     publish_ts=PUB_TS)
            frames = []
            for srv in (server, jserver):
                with srv._frame_lock, mock.patch("time.time",
                                                 lambda: FIXED_CLOCK):
                    srv._refresh_locked()
                    base = 1 if kind == "delta" and version == 2 else -1
                    frames.append(srv._frame_locked(0, version, codec,
                                                    base)[0])
            assert frames[0] == frames[1]
    finally:
        server.close()
        jserver.close()


def _expected(params: dict, codec: str) -> dict[str, np.ndarray]:
    """What a puller must rebuild: the decoded codec image of the frame's
    Flax tree, in torch names."""
    flat = tws._flatten(params)
    dec = twp.decode_flat(twp.encode_flat(flat, codec))
    return torch_layout(tws._unflatten(dec)["params"])


def _pull(client, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = client.get_if_newer()
        if got is not None:
            return got
        time.sleep(0.01)
    raise AssertionError("no frame pulled")


@pytest.mark.parametrize("codec", twp.CODECS)
def test_reference_client_pulls_from_a_torch_server(codec):
    p1, p2 = _actor(3), _step(_actor(3), 4)
    store = WeightStore()
    server = twp.WeightPlaneServer(store, window=4)
    client = jwp.WeightPlaneClient("127.0.0.1", server.port, codec=codec,
                                   connect_timeout=5.0)
    try:
        for version, p in ((1, p1), (2, p2)):
            store.publish(p, step=version, norm_stats=NORM)
            got_version, tree = _pull(client)
            assert got_version == version
            want = _expected(p, codec)
            got = torch_layout(tree["params"])
            assert _same_bytes(dict(sorted(got.items())),
                               dict(sorted(want.items())))
            np.testing.assert_array_equal(client.norm_stats[0], NORM[0])
            assert client.norm_stats[2] == 3.5
        assert client.counters["full_frames"] == 1
        assert client.counters["delta_frames"] == 1
        stats = server.weight_stats()
        assert stats["oracle_delta_failures"] == 0
        assert stats["oracle_quant_failures"] == 0
    finally:
        client.close()
        server.close()


@pytest.mark.parametrize("codec", twp.CODECS)
def test_torch_client_pulls_from_a_reference_server(codec):
    p1, p2 = _actor(5), _step(_actor(5), 6)
    jstore = JaxStore()
    server = jwp.WeightPlaneServer(jstore, window=4)
    client = twp.WeightPlaneClient("127.0.0.1", server.port, codec=codec,
                                   connect_timeout=5.0)
    try:
        for version, p in ((1, p1), (2, p2)):
            jstore.publish(flax_layout(p), step=version, to_host=False,
                           norm_stats=NORM)
            got_version, params = _pull(client)
            assert got_version == version and client.step == version
            want = _expected(p, codec)
            assert set(params) == set(want) == set(p)
            for name, t in params.items():
                assert isinstance(t, torch.Tensor)
                assert t.numpy().tobytes() == want[name].tobytes(), name
            if codec == "f32":
                for name, t in params.items():
                    assert torch.equal(t, p[name])
        assert client.counters["full_frames"] == 1
        assert client.counters["delta_frames"] == 1
        assert client.get_if_newer() is None
        assert client.counters["not_newer"] == 1
    finally:
        client.close()
        server.close()


@pytest.mark.parametrize("client_pkg", ["torch", "reference"])
def test_v1_client_against_the_plane_server(client_pkg):
    """Both protocols on one port: a v1 puller gets the v1 frame, with
    the normalizer statistics."""
    store = WeightStore()
    server = twp.WeightPlaneServer(store, window=4)
    Client = tws.WeightClient if client_pkg == "torch" else jws.WeightClient
    client = Client("127.0.0.1", server.port, connect_timeout=5.0)
    try:
        p = _actor(7)
        store.publish(p, step=3, norm_stats=NORM)
        version, params = client.get_if_newer(0)
        assert version == 1 and client.step == 3
        assert client.norm_stats[2] == 3.5
        named = (params if client_pkg == "torch"
                 else torch_layout(params["params"]))
        for name, t in p.items():
            np.testing.assert_array_equal(np.asarray(named[name]), t.numpy())
        assert client.get_if_newer(version) is None
        assert server.weight_stats()["frames_v1"] == 2
        assert server.pulls_served == 1
    finally:
        client.close()
        server.close()


def _pull_until(client, want_version, timeout=10.0, want_gen=None):
    deadline = time.monotonic() + timeout
    res = None
    while time.monotonic() < deadline:
        got = client.get_if_newer()
        if got is not None:
            res = got
        if (client.version >= want_version
                and (want_gen is None or client.generation == want_gen)):
            return res
        time.sleep(0.02)
    raise AssertionError(
        f"never reached v{want_version} (at v{client.version} "
        f"gen{client.generation})")


def test_relay_chain_torch_reference_torch():
    """A torch server feeds a reference relay, which feeds a torch relay,
    which a torch leaf pulls bf16 from; a generation bump at the root
    reaches the leaf and its version rewind is adopted."""
    p = _actor(8)
    store = WeightStore(generation=0)
    server = twp.WeightPlaneServer(store, window=4)
    r1 = jwp.WeightRelay("127.0.0.1", server.port, poll_interval=0.01,
                         window=4)
    r2 = twp.WeightRelay("127.0.0.1", r1.port, poll_interval=0.01, window=4)
    leaf = twp.WeightPlaneClient("127.0.0.1", r2.port, codec="bf16",
                                 connect_timeout=5.0)
    try:
        store.publish(p, step=1, norm_stats=NORM)
        version, params = _pull_until(leaf, 1)
        assert version == 1 and leaf.norm_stats[2] == 3.5
        want = _expected(p, "bf16")
        for name, t in params.items():
            assert t.numpy().tobytes() == want[name].tobytes(), name
        store.publish_versioned(p, version=1, step=2, generation=1)
        _pull_until(leaf, 1, want_gen=1)
        assert (leaf.generation, leaf.version) == (1, 1)
        assert r1.gen_adoptions >= 1 and r2.gen_adoptions >= 1
        assert r2.generation == 1
    finally:
        leaf.close()
        r2.close()
        r1.close()
        server.close()


# ------------------------- the reference's tests/test_weight_plane.py ----

def test_full_then_delta_pull_and_memo_single_flight():
    store = WeightStore()
    srv = twp.WeightPlaneServer(store, window=4)
    clients = []
    try:
        store.publish(_actor(10), step=1)
        clients = [twp.WeightPlaneClient("127.0.0.1", srv.port,
                                         connect_timeout=5.0)
                   for _ in range(4)]
        for c in clients:
            assert c.get_if_newer()[0] == 1
        stats = srv.weight_stats()
        # 4 pullers, one encode and one frame build (single flight)
        assert stats["codec_encodes"] == 1 and stats["frames_full"] == 4
        assert stats["frame_memo_len"] == 1
        store.publish(_step(_actor(10), 11), step=2)
        for c in clients:
            assert c.get_if_newer()[0] == 2
            assert c.counters["delta_frames"] == 1
        stats = srv.weight_stats()
        assert stats["frames_delta"] == 4 and stats["delta_hit_rate"] == 0.5
        for c in clients:
            assert c.get_if_newer() is None
    finally:
        for c in clients:
            c.close()
        srv.close()


def test_quantized_transport_end_to_end():
    store = WeightStore()
    srv = twp.WeightPlaneServer(store, window=4)
    try:
        p = _actor(12)
        store.publish(p, step=1)
        for codec, tol in (("bf16", twp.BF16_REL_BOUND), ("int8", 1 / 127)):
            c = twp.WeightPlaneClient("127.0.0.1", srv.port, codec=codec,
                                      connect_timeout=5.0)
            _, got = c.get_if_newer()
            w, gw = p["fc1.weight"], got["fc1.weight"]
            assert float((gw - w).abs().max()) <= \
                tol * float(w.abs().max()) + 1e-6
            c.close()
        stats = srv.weight_stats()
        assert stats["oracle_quant_failures"] == 0
        assert stats["oracle_quant_checks"] >= 2
    finally:
        srv.close()


def test_out_of_window_puller_falls_back_to_full():
    store = WeightStore()
    srv = twp.WeightPlaneServer(store, window=2)
    c = twp.WeightPlaneClient("127.0.0.1", srv.port, connect_timeout=5.0)
    helper = twp.WeightPlaneClient("127.0.0.1", srv.port,
                                   connect_timeout=5.0)
    try:
        p = _actor(13)
        store.publish(p, step=1)
        assert c.get_if_newer()[0] == 1
        # the window takes versions in at serve time: a helper pulls each
        # publish so v2..v4 enter it and v1 ages out
        for step in (2, 3, 4):
            p = _step(p, step)
            store.publish(p, step=step)
            helper.get_if_newer()
        assert c.get_if_newer()[0] == 4
        assert c.counters["full_frames"] == 2  # the base left: full
        assert c.counters["delta_frames"] == 0
    finally:
        helper.close()
        c.close()
        srv.close()


def test_torn_payload_refused_never_accepted():
    store = WeightStore()
    chaos = twp.WeightWireChaos(torn_prob=1.0, seed=1)
    srv = twp.WeightPlaneServer(store, chaos=chaos)
    c = twp.WeightPlaneClient("127.0.0.1", srv.port,
                              reconnect_interval=0.01, connect_timeout=5.0)
    try:
        store.publish(_actor(14), step=1)
        for _ in range(3):
            assert c.get_if_newer() is None
            time.sleep(0.02)
        assert c.counters["torn_rejected"] >= 1
        assert c.counters["accepts"] == 0
        assert srv.weight_stats()["torn_injected"] >= 1
        chaos.torn_prob = 0.0  # chaos off: the client recovers
        assert _pull_until(c, 1)[0] == 1
    finally:
        c.close()
        srv.close()


def test_generation_fence_client_refuses_a_pre_crash_frame():
    p = _actor(15)
    store0 = WeightStore(generation=0)
    srv0 = twp.WeightPlaneServer(store0)
    store0.publish(p, step=1)
    store0.publish(p, step=2)
    pre_crash = srv0.latest_full_payload()  # generation 0, version 2
    srv0.close()
    store1 = WeightStore(generation=1)
    chaos = twp.WeightWireChaos(stale_prob=1.0, seed=2)
    chaos.stash.append(pre_crash)
    srv1 = twp.WeightPlaneServer(store1, chaos=chaos)
    c = twp.WeightPlaneClient("127.0.0.1", srv1.port, connect_timeout=5.0)
    try:
        store1.publish(p, step=3)  # generation 1, version 1: it rewinds
        c.generation = 1  # has seen generation 1 (say, through a relay)
        assert c.get_if_newer() is None  # the injected frame is fenced
        assert c.counters["fenced_rejected"] == 1
        chaos.stale_prob = 0.0
        res = c.get_if_newer()
        assert res is not None and res[0] == 1
        assert (c.generation, c.version) == (1, 1)
    finally:
        c.close()
        srv1.close()


def test_generation_bump_purges_the_server_window():
    store = WeightStore(generation=0)
    srv = twp.WeightPlaneServer(store, window=8)
    c = twp.WeightPlaneClient("127.0.0.1", srv.port, connect_timeout=5.0)
    try:
        store.publish(_actor(16), step=1)
        assert c.get_if_newer()[0] == 1
        store.publish_versioned(_actor(17), version=1, step=9, generation=1)
        version, _ = c.get_if_newer()
        assert version == 1 and c.generation == 1
        stats = srv.weight_stats()
        assert stats["window_purged_generations"] == 1
        assert stats["window_len"] == 1  # only generation 1's entry
    finally:
        c.close()
        srv.close()


def test_plane_serve_traces_never_orphan():
    store = WeightStore()
    srv = twp.WeightPlaneServer(store)
    RECORDER.reset()
    RECORDER.enable(sample_rate=1.0)
    c = twp.WeightPlaneClient("127.0.0.1", srv.port, connect_timeout=5.0)
    try:
        store.publish(_actor(18), step=1)
        assert c.get_if_newer()[0] == 1  # the commit terminal
        store.publish(_step(_actor(18), 19), step=2)
        # a delta against a base this client does not hold is shed, not
        # applied
        with srv._frame_lock:
            srv._refresh_locked()
            payload, _, _ = srv._frame_locked(0, 2, "f32", 1)
        c.version = 0
        assert c._accept(payload) is None
        assert c.counters["delta_base_misses"] == 1
        assert _pull_until(c, 2)[0] == 2  # the full retry commits
        c.close()
        deadline = time.monotonic() + 5.0
        while RECORDER.orphans() and time.monotonic() < deadline:
            time.sleep(0.02)  # the teardown sweep settles
        assert RECORDER.orphans() == []
    finally:
        RECORDER.disable()
        RECORDER.reset()
        c.close()
        srv.close()


def test_v1_norm_stats_survive_a_reconnect():
    """Across a server restart the v1 client keeps its last statistics
    while degraded and takes the new incarnation's on its first frame."""
    p = _actor(20)
    store = WeightStore()
    srv = twp.WeightPlaneServer(store)
    port = srv.port
    store.publish(p, step=1, norm_stats=(np.zeros(3), np.ones(3), 5.0))
    c = tws.WeightClient("127.0.0.1", port, reconnect_interval=0.01,
                         connect_timeout=5.0)
    srv2 = None
    try:
        v, _ = c.get_if_newer(0)
        assert v == 1 and float(c.norm_stats[2]) == 5.0
        srv.close()
        assert c.get_if_newer(v) is None  # degraded: stale weights
        assert c.norm_stats is not None   # and the stale statistics kept
        deadline = time.monotonic() + 10.0
        while srv2 is None:
            try:
                srv2 = twp.WeightPlaneServer(store, port=port)
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.05)
        store.publish(p, step=2, norm_stats=(np.ones(3), np.ones(3), 9.0))
        deadline = time.monotonic() + 5.0
        res = None
        while res is None and time.monotonic() < deadline:
            res = c.get_if_newer(v)
            time.sleep(0.02)
        assert res is not None and res[0] == 2
        assert float(c.norm_stats[2]) == 9.0
    finally:
        c.close()
        srv.close()
        if srv2 is not None:
            srv2.close()


def test_weights_provider_sums_the_live_servers():
    from d4pg_tpu_torch.obs.registry import REGISTRY

    store = WeightStore()
    srv = twp.WeightPlaneServer(store)
    c = twp.WeightPlaneClient("127.0.0.1", srv.port, connect_timeout=5.0)
    try:
        store.publish(_actor(21), step=1)
        assert c.get_if_newer()[0] == 1
        snap = REGISTRY.export()["weights"]
        assert snap["servers"] >= 1 and snap["frames_full"] >= 1
        assert snap["staleness_ms"]["count"] >= 1
    finally:
        c.close()
        srv.close()
