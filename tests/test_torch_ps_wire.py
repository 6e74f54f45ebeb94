"""The port's parameter server, wire and codecs against the JAX package's,
on the CPU:

* the update rules (``DeltaParameterServer``, ``ADAGParameterServer``,
  ``DynSGDParameterServer``) from one seeded center and one seeded
  sequence of commits give bit-identical centers, staleness and
  histograms;
* ``utils.native.fused_add`` (the commit rule's data plane, built from
  ``native/dknative.cpp``) equals numpy's ``a + scale*b`` bit for bit;
* ``pack_msg`` at v1 and v2 and ``pack_stream`` give the JAX package's
  bytes for the same messages, codec stubs (UP and DOWN) included, and
  each package decodes the other's stubs to the same arrays;
* live interop: a port ``PSClient`` against a JAX
  ``SocketParameterServer`` and the reverse give bit-identical centers
  under codec ``none`` at wire v1, v2, with the shared-memory ring and
  with streamed pulls, and the same centers under every codec and
  ``comm_down``;
* the telemetry plane: ``telemetry`` frames from either package's client
  fold into the port server's ``TimeSeriesStore``, which matches the JAX
  package's store on one feed; ``alerts`` answers the alert engine's
  state document.
"""

import numpy as np
import pytest

from distkeras_tpu.ps import client as jcli
from distkeras_tpu.ps import codecs as jcod
from distkeras_tpu.ps import networking as jnet
from distkeras_tpu.ps import servers as jsrv
from distkeras_tpu.utils import serde as jserde

from distkeras_tpu_torch.ps import client as pcli
from distkeras_tpu_torch.ps import codecs as pcod
from distkeras_tpu_torch.ps import networking as pnet
from distkeras_tpu_torch.ps import servers as psrv
from distkeras_tpu_torch.utils import native
from distkeras_tpu_torch.utils import serde as pserde
from distkeras_tpu_torch.utils.tree import tree_flatten

RULES = ("DeltaParameterServer", "ADAGParameterServer",
         "DynSGDParameterServer")
CODECS = ("int8", "bf16", "topk0.1")
#: the streamed-pull chunk bound (the wire's floor): the center's two
#: big leaves then travel in chunks of their own
CHUNK = pnet.MIN_STREAM_CHUNK_BYTES


def _center(seed=0):
    """A JAX-shaped variables tree: two leaves past the stream chunk
    bound, small ones, and an int32 state leaf (which no rule moves)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"params": [{"bias": f(300), "kernel": f(64, 300)},
                       {"kernel": f(300, 70)}],
            "state": [{}, {"count": np.arange(2, dtype=np.int32),
                           "mean": f(70)}]}


def _deltas(n, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        d = _center(int(rng.integers(1 << 30)))
        d = {"params": [{k: (v * 0.01).astype(np.float32)
                         for k, v in layer.items()}
                        for layer in d["params"]],
             "state": [{}, {"count": np.ones(2, np.int32),
                            "mean": d["state"][1]["mean"] * 0.01}]}
        out.append(d)
    return out


def _flat(tree):
    return tree_flatten(tree)[0]


def _assert_bitwise(a, b):
    la, lb = _flat(a), _flat(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def _bytes(payload):
    bufs, total = payload
    out = b"".join(bytes(memoryview(b).cast("B")) if memoryview(b).nbytes
                   else b"" for b in bufs)
    assert len(out) == total
    return out


# ---------------------------------------------------------------------------
# the data plane and the update rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_native_fused_add_equals_numpy_bit_for_bit(dtype):
    """``fused_add`` runs the native library (built from the checkout's
    ``native/dknative.cpp`` into ``_build/``, never under ``native/``);
    its result equals numpy's at sizes below and above the threading
    grain, for the rules' scales (1, 1/W, 1/(staleness+1), weights)."""
    assert native.available()
    assert native.lib_path().startswith(native.BUILD_DIR)
    rng = np.random.default_rng(0)
    for n in (1, 1000, (1 << 16) + 7, 300_001):
        a = rng.normal(size=n).astype(dtype)
        b = rng.normal(size=n).astype(dtype)
        for scale in (1.0, 0.25, 1 / 3, 0.1 / 7, -2.5):
            got = native.fused_add(a, b, scale)
            want = (a + np.asarray(b, a.dtype) * scale).astype(a.dtype)
            assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("rule", RULES)
def test_update_rules_give_the_jax_centers_bit_for_bit(rule):
    """Twelve commits from three workers, DynSGD's ``last_update`` lagging
    by 0–3, one straggler weight and one tombstoned zombie commit."""
    center = _center()
    jps = getattr(jsrv, rule)(center, num_workers=3)
    pps = getattr(psrv, rule)(center, num_workers=3)
    for i, d in enumerate(_deltas(12)):
        meta = {"worker_id": i % 3, "last_update": max(0, i - i % 4)}
        if i == 5:
            meta["commit_weight"] = 0.5
        assert jps.handle_commit(d, dict(meta)) == \
            pps.handle_commit(d, dict(meta))
        if i == 8:
            assert jps.evict_worker(1) == pps.evict_worker(1)
    _assert_bitwise(pps.get_model(), jps.get_model())
    assert pps.num_updates == jps.num_updates == 11
    assert pps.commits_by_worker == jps.commits_by_worker
    assert pps.tombstoned_by_worker == jps.tombstoned_by_worker == {1: 1}
    if rule == "DynSGDParameterServer":
        assert list(pps.staleness_seen) == list(jps.staleness_seen)
        assert max(pps.staleness_seen) == 3
    js, ps_ = jps.registry.snapshot(), pps.registry.snapshot()
    for name in js:
        if js[name]["type"] in ("counter", "gauge") or "staleness" in name:
            assert ps_[name] == js[name], name


# ---------------------------------------------------------------------------
# frames and codec stubs
# ---------------------------------------------------------------------------

def _messages():
    center, (delta,) = _center(), _deltas(1)
    return [{"action": "hello", "versions": [1, 2], "worker_id": 3},
            {"center": center, "updates": 7},
            {"action": "commit", "worker_id": 1, "gen": 2, "delta": delta,
             "codec": "none", "gap_s": 0.125, "last_update": 5,
             "trace": {"trace_id": "w1", "parent_span": "w1.x1"}},
            {"ok": True, "dropped": False, "stats": {"a": [1, 2.5, None]}},
            {"unchanged": True, "updates": 7}]


@pytest.mark.parametrize("version", [1, 2])
def test_pack_msg_bytes_are_the_jax_packages(version):
    for msg in _messages():
        assert _bytes(pnet.pack_msg(msg, version)) == \
            _bytes(jnet.pack_msg(msg, version))


def test_pack_stream_bytes_are_the_jax_packages():
    doc = {"center": _center(), "updates": 4}
    pparts = pnet.pack_stream(doc, CHUNK)
    jparts = jnet.pack_stream(doc, CHUNK)
    assert len(pparts) == len(jparts) >= 3
    for p, j in zip(pparts, jparts):
        assert _bytes(p) == _bytes(j)


@pytest.mark.parametrize("spec", CODECS)
def test_codec_stubs_are_the_jax_packages(spec):
    """Three windows through each package's codec (error feedback
    carried): the encoded commits pack to the same bytes, the DOWN
    residuals too, and each package decodes the other's wire bytes to
    the same arrays."""
    jc, pc = jcod.get_codec(spec), pcod.get_codec(spec)
    for d in _deltas(3, seed=4):
        jenc, penc = jc.encode(d), pc.encode(d)
        for version in (1, 2):
            msg = lambda enc: {"action": "commit", "delta": enc,  # noqa
                               "codec": spec}
            assert _bytes(pnet.pack_msg(msg(penc), version)) == \
                _bytes(jnet.pack_msg(msg(jenc), version))
        assert pcod.tree_payload_bytes(penc) == \
            jcod.tree_payload_bytes(jenc)
        # across the wire: port decodes JAX's bytes and the reverse
        from_jax = pserde.tree_from_bytes(jserde.tree_to_bytes(jenc))
        from_port = jserde.tree_from_bytes(pserde.tree_to_bytes(penc))
        want = jcod.decode_tree(jenc)
        _assert_bitwise(pcod.decode_tree(from_jax), want)
        _assert_bitwise(_host(jcod.decode_tree(from_port)), want)
    center, ref = _center(5), _center(6)
    pres = pcod.encode_ref_delta(center, ref, spec)
    jres = jcod.encode_ref_delta(center, ref, spec)
    assert _bytes(pnet.pack_msg({"residual": pres}, 2)) == \
        _bytes(jnet.pack_msg({"residual": jres}, 2))
    _assert_bitwise(pcod.apply_ref_delta(ref, pserde.tree_from_bytes(
        jserde.tree_to_bytes(jres))), _host(jcod.apply_ref_delta(ref, jres)))


def _host(tree):
    return tree_flatten(tree)[1](
        [np.asarray(x) for x in _flat(tree)])


# ---------------------------------------------------------------------------
# live interop over loopback
# ---------------------------------------------------------------------------

#: (client kwargs, server kwargs) per wire option
WIRES = {"v1": (dict(wire_version=1), {}),
         "v2": (dict(stream=False), {}),
         "shm": (dict(shm=True, stream=False), {}),
         "stream": (dict(stream=True, stream_chunk_bytes=CHUNK), {})}


def _drive(client_mod, server_mod, rule, n, client_kw, server_kw=None,
           pull_kw=None):
    """``n`` commits of the seeded deltas from one client of
    ``client_mod`` to a ``server_mod`` server, a pull after each; returns
    (the server's center, the client's last pulled center, the server's
    registry snapshot once it stopped — its handler counts the ``stop``
    ack after the client may already have read it — and the client's
    negotiated wire)."""
    ps = getattr(server_mod, rule)(_center(), num_workers=2)
    with server_mod.SocketParameterServer(ps, **(server_kw or {})) as srv:
        c = client_mod.PSClient("127.0.0.1", srv.port, worker_id=1,
                                **client_kw)
        try:
            for d in _deltas(n):
                _, seen = c.pull()
                assert c.commit(d, last_update=seen)
            pulled, _ = c.pull()
            info = (c.wire_version, c.shm_active, c.stream_enabled)
        finally:
            c.close()
    return ps.get_model(), pulled, ps.registry.snapshot(), info


@pytest.mark.parametrize("wire", list(WIRES))
def test_port_client_and_jax_server_interoperate(wire):
    """Port client → JAX server and JAX client → port server each give
    the center a JAX client → JAX server run gives, bit for bit, and the
    pulled center is the server's."""
    ckw, skw = WIRES[wire]
    want, _, _, jinfo = _drive(jcli, jsrv, "DynSGDParameterServer", 4, ckw,
                               skw)
    for cmod, smod in ((pcli, jsrv), (jcli, psrv)):
        got, pulled, snap, info = _drive(cmod, smod, "DynSGDParameterServer",
                                         4, ckw, skw)
        assert info == jinfo
        _assert_bitwise(got, want)
        _assert_bitwise(pulled, want)
        assert snap["ps.commits"]["value"] == 4
    assert jinfo == {"v1": (1, False, False), "v2": (2, False, False),
                     "shm": (2, True, False),
                     "stream": (2, False, True)}[wire]


@pytest.mark.parametrize("spec", CODECS)
def test_codecs_and_down_interoperate(spec):
    """Every codec UP and ``comm_down`` DOWN across the packages: the
    servers' centers and the decoded pulls equal the JAX-only run's."""
    kw = dict(codec=spec, down="int8" if spec != "int8" else "bf16",
              stream=False)
    want, want_pull, jsnap, _ = _drive(jcli, jsrv, "DeltaParameterServer",
                                       3, kw)
    for cmod, smod in ((pcli, jsrv), (jcli, psrv)):
        got, pulled, snap, _ = _drive(cmod, smod, "DeltaParameterServer", 3,
                                      kw)
        _assert_bitwise(got, want)
        _assert_bitwise(_host(pulled), _host(want_pull))
        for name in ("ps.codec.bytes_encoded", "ps.down.bytes_encoded",
                     "ps.wire.bytes_up", "ps.wire.bytes_down"):
            assert snap[name]["value"] == jsnap[name]["value"], name


def test_unported_telemetry_actions_answer_an_error():
    """The ``alerts`` action, an error before the alert engine was ported,
    now answers: no engine and no store before ``enable_alerts``, then the
    engine's state document (the committed rules) and the store; the
    connection keeps serving."""
    import json
    import os
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "OBS_BASELINE.json")) as f:
        rules = json.load(f)["alerts"]
    ps = psrv.DeltaParameterServer(_center())
    with psrv.SocketParameterServer(ps) as srv:
        with pcli.PSClient("127.0.0.1", srv.port) as c:
            assert c._rpc({"action": "alerts"}) == \
                {"ok": True, "alerts": None, "telemetry": None}
            srv.enable_alerts(rules)
            doc = c._rpc({"action": "alerts"})
            assert doc["ok"]
            assert [r["name"] for r in doc["alerts"]["rules"]] == \
                [r["name"] for r in rules]
            assert doc["alerts"]["counts"]["fired"] == 0
            assert "_local" in doc["telemetry"]["sources"]
            assert c.stats()["num_updates"] == 0


def _telemetry_frames():
    """Cumulative snapshots of one live registry, then a garbage entry."""
    from distkeras_tpu_torch.obs import Registry
    reg = Registry()
    frames = []
    for i in range(4):
        reg.counter("ps.commits").inc(3 + i)
        reg.gauge("ps.queue").set(i)
        reg.histogram("ps.commit_seconds").observe(0.01 * (i + 1))
        frames.append(reg.snapshot())
    return frames


@pytest.mark.parametrize("client_pkg", ["torch", "jax"])
def test_telemetry_frames_fold_into_the_servers_store(client_pkg):
    """A shipped ``telemetry`` frame (from a client of either package)
    folds into the port server's lazily created ``TimeSeriesStore``,
    bad entries rejected one by one, as the JAX front-ends do."""
    from distkeras_tpu.obs.drift import snapshot_delta
    cls = pcli.PSClient if client_pkg == "torch" else jcli.PSClient
    frames = _telemetry_frames()
    ps = psrv.DeltaParameterServer(_center())
    with psrv.SocketParameterServer(ps) as srv:
        assert srv.telemetry is None
        with cls("127.0.0.1", srv.port) as c:
            prev = {}
            for snap in frames:
                reply = c.ship_telemetry(snapshot_delta(prev, snap),
                                         source="w0")
                assert reply == {"ok": True, "accepted": 3}
                prev = snap
            bad = c.ship_telemetry({"x": {"type": "counter",
                                          "value": float("nan")}},
                                   source="w1")
            assert bad["accepted"] == 0
        store = srv.telemetry
        assert sorted(store.summary()["sources"]) == ["w0", "w1"]
        latest = store.latest()
        assert latest["ps.commits"]["value"] == frames[-1][
            "ps.commits"]["value"]
        assert latest["ps.commit_seconds"]["count"] == 4
        assert srv.registry.snapshot()["obs.telemetry.rejected"][
            "value"] == 1


def test_time_series_store_matches_jax():
    """One feed (deltas, cumulative totals with a restart, a hostile
    entry) into both packages' stores at fixed timestamps: the same
    merged totals, windowed deltas, series and summaries."""
    from distkeras_tpu.obs.timeseries import TimeSeriesStore as JStore
    from distkeras_tpu_torch.obs.timeseries import TimeSeriesStore
    frames = _telemetry_frames()
    feeds = [("ingest_total", "e0", f, 10.0 + i)
             for i, f in enumerate(frames)]
    feeds.append(("ingest_total", "e0", frames[0], 20.0))   # a restart
    feeds.append(("ingest_delta", "w1",
                  {"ok": {"type": "counter", "value": 2},
                   "bad": {"type": "histogram", "bounds": [1, 0],
                           "counts": [0, 0, 0], "sum": 0, "count": 0}},
                  21.0))
    out = {}
    for name, cls in (("jax", JStore), ("torch", TimeSeriesStore)):
        store = cls(clock=lambda: 22.0)
        accepted = [getattr(store, fn)(src, doc, ts=ts)
                    for fn, src, doc, ts in feeds]
        out[name] = (accepted, store.latest(), store.names(),
                     [store.window_delta(n, 5.0) for n in store.names()],
                     [store.series(n) for n in store.names()],
                     store.summary())
    assert out["torch"] == out["jax"]
