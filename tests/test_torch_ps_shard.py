"""The port's sharded parameter server (``ps.shard``) against the JAX
package's, on the CPU — the port of ``tests/test_ps_shard.py``'s cases
(:58-459) and the interop between the packages:

* ``ShardPlan``: digest, placement, split and assemble equal the JAX
  package's for the same tree (an MLP's variables, a tree of bfloat16,
  f32, integer and scalar leaves, the MoE LM's with its ``aux_loss``
  state), from numpy trees and from the port's live tensors alike;
* the ``hello`` descriptor and the ``plan`` RPC (a v1 client verifies
  through it), a mismatched plan refused at connect;
* a port ``ShardedPSClient`` against a JAX ``ShardedParameterServer`` and
  a JAX client against the port's fleet: the centers are bit-identical to
  the JAX pair's after the same commits;
* a consistent cut under concurrent commits, per-shard DynSGD staleness
  and codec state, a partial drop repaired, a permanent drop giving up
  within its bound, a full drop, eviction fanning out with tombstones;
* a dead shard raising a named ``ShardFleetError``, also out of a running
  trainer; ``ProcessShardFleet`` end to end;
* ``ps_shards=2`` with one worker bit-identical to the single server, and
  within the sync trainers' bound of the JAX package's sharded run
  (rtol 1e-5 plus 1e-6 of the largest |value|, ``tests/test_torch_dist.py``).
"""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.data.transformers import OneHotTransformer as JaxOneHot
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.models.layers import Dense as JaxDense
from distkeras_tpu.models.layers import Sequential as JaxSequential
from distkeras_tpu.ps import shard as jshard
from distkeras_tpu.ps import servers as jservers

import distkeras_tpu_torch as dkt
from distkeras_tpu_torch import chaos
from distkeras_tpu_torch.data.transformers import OneHotTransformer
from distkeras_tpu_torch.models import Model
from distkeras_tpu_torch.obs import Registry
from distkeras_tpu_torch.ps import PSClient, WorkerEvicted
from distkeras_tpu_torch.ps import workers as workers_mod
from distkeras_tpu_torch.ps import servers as port_servers
from distkeras_tpu_torch.ps.servers import (DeltaParameterServer,
                                            DynSGDParameterServer,
                                            SocketParameterServer)
from distkeras_tpu_torch.ps.shard import (ProcessShardFleet,
                                          ShardedParameterServer,
                                          ShardedPSClient, ShardFleetError,
                                          ShardPlan, ShardPlanMismatch,
                                          merge_fleet_stats)
from distkeras_tpu_torch.utils import load_jax_variables
from distkeras_tpu_torch.utils.weights import (jax_variables,
                                               to_numpy_variables)
from tests.test_torch_racecheck import racecheck_module

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

#: the port's race checker over this file's PS / fleet threads
_port_racecheck = racecheck_module()

SIZES = (2048, 1024, 512, 256)
COMMON = dict(loss="categorical_crossentropy", features_col="features",
              label_col="label_onehot", batch_size=32, learning_rate=0.05,
              communication_window=4, mode="async")


def center_tree(sizes=SIZES):
    return {"params": [{"w": np.zeros(n, np.float32)} for n in sizes],
            "state": [{} for _ in sizes]}


def ones_like_center(sizes=SIZES, v=1.0):
    return {"params": [{"w": np.full(n, v, np.float32)} for n in sizes],
            "state": [{} for _ in sizes]}


def _wait(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout_s}s waiting for {what}")


def _jax_mlp():
    return dk.Model(JaxSequential([JaxDense(32, "relu"),
                                   JaxDense(3, "softmax")]),
                    input_shape=(10,))


def _port_of(jm):
    """The port's model of ``jm``'s config, ``init(seed)`` loading the JAX
    model's ``init(seed)`` weights."""
    model = Model.from_config(jm.config())
    build = model.init

    def init(seed=0, device=None):
        build(seed, device=device)
        load_jax_variables(model, jax.tree_util.tree_map(
            np.asarray, jm.init(seed)))
        return model
    model.init = init
    return model


@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, 10)).astype(np.float32)
    w = rng.normal(size=(10, 3)).astype(np.float32)
    y = np.argmax(x @ w + 0.1 * rng.normal(size=(512, 3)), axis=-1)
    jds = JaxOneHot(3, "label", "label_onehot").transform(
        dk.Dataset({"features": x, "label": y}))
    pds = OneHotTransformer(3, "label", "label_onehot").transform(
        dkt.Dataset({"features": x, "label": y}))
    return jds, pds


# -- ShardPlan -----------------------------------------------------------------

def _trees():
    """(JAX-side tree, the port's trees of it) per case."""
    mlp = jax.tree_util.tree_map(np.asarray, _jax_mlp().init(0))
    mixed_jax = {"params": [{"w": np.zeros((64, 32), jnp.bfloat16),
                             "b": np.zeros(32, np.float32)},
                            {"w": np.zeros((96,), jnp.bfloat16)}],
                 "state": [{"step": np.array(3, np.int64)},
                           {"scale": 0.5}]}
    mixed_port = {"params": [{"w": torch.zeros((64, 32),
                                               dtype=torch.bfloat16),
                              "b": torch.zeros(32)},
                             {"w": torch.zeros(96, dtype=torch.bfloat16)}],
                  "state": [{"step": torch.tensor(3)}, {"scale": 0.5}]}
    jm = jax_zoo.gpt_lm(vocab_size=17, dim=32, num_heads=2, num_blocks=2,
                        seq_len=16, attention_impl="flash", moe_experts=4)
    moe_jax = jax.tree_util.tree_map(np.asarray, jm.init(0))
    pm = Model.from_config(jm.config()).init(0, device="cpu")
    load_jax_variables(pm, moe_jax)
    return {"mlp": (mlp, [mlp]),
            "bf16_mixed": (mixed_jax, [mixed_port]),
            "moe_lm": (moe_jax, [to_numpy_variables(pm), jax_variables(pm)])}


@pytest.fixture(scope="module")
def trees():
    return _trees()


@pytest.mark.parametrize("shards", [1, 2, 3])
@pytest.mark.parametrize("case", ["bf16_mixed", "mlp", "moe_lm"])
def test_plan_matches_jax(case, shards, trees):
    ref_tree, port_trees = trees[case]
    ref = jshard.ShardPlan.build(ref_tree, shards)
    for tree in port_trees:
        plan = ShardPlan.build(tree, shards)
        assert plan.digest == ref.digest
        assert plan.assignments == ref.assignments
        assert plan.leaf_bytes == ref.leaf_bytes
        assert plan.doc() == ref.doc()
        got, want = plan.split(tree), ref.split(ref_tree)
        assert [sorted(s) for s in got] == [sorted(s) for s in want]
        back = plan.assemble(*got)
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(tree)
    if case == "moe_lm":
        paths = set(ref.assignments)
        assert {"state/3/inner/1/aux_loss",
                "state/5/inner/1/aux_loss"} <= paths
        assert ref.leaf_bytes["state/3/inner/1/aux_loss"] == 4
    if case == "bf16_mixed":
        assert ref.leaf_bytes["params/0/w"] == 64 * 32 * 2
        assert ref.leaf_bytes["state/1/scale"] == 8


def test_plan_is_deterministic_balanced_and_round_trips(rng):
    c = center_tree()
    p1, p2 = ShardPlan.build(c, 2), ShardPlan.build(c, 2)
    assert p1.digest == p2.digest and p1.assignments == p2.assignments
    loads = [0, 0]
    for path, shard in p1.assignments.items():
        loads[shard] += p1.leaf_bytes[path]
    assert max(loads) / min(loads) < 1.5, loads
    assert ShardPlan.build(c, 3).digest != p1.digest
    assert ShardPlan.build(center_tree((8, 4)), 2).digest != p1.digest
    assert ShardPlan.build(c, 2, epoch=1).digest != p1.digest
    with pytest.raises(ValueError, match="num_shards"):
        ShardPlan.build(c, 0)
    tree = {"params": [{"w": rng.normal(size=(4, 5)).astype(np.float32)},
                       {"w": rng.normal(size=(7,)).astype(np.float32),
                        "b": rng.normal(size=(3,)).astype(np.float32)}],
            "state": [{}, {"step": np.array(3, np.int64)}]}
    plan = ShardPlan.build(tree, 3)
    slices = plan.split(tree)
    assert sum(len(s) for s in slices) == 4
    back = plan.assemble(*slices)
    assert back["state"][0] == {}   # empty containers survive
    np.testing.assert_array_equal(back["params"][1]["b"],
                                  tree["params"][1]["b"])
    with pytest.raises(KeyError, match="missing leaf"):
        plan.assemble(slices[0])
    doc = ShardPlan.build(c, 2).doc(
        addresses=[("127.0.0.1", 1001), ("127.0.0.1", 1002)])
    assert [s["port"] for s in doc["shards"]] == [1001, 1002]
    assert sorted(p for s in doc["shards"] for p in s["paths"]) == \
        sorted(ShardPlan.build(c, 2).assignments)


# -- hello negotiation and plan agreement ------------------------------------

def test_hello_carries_shard_descriptor_and_plan_rpc():
    c = center_tree()
    with ShardedParameterServer(c, 2, DeltaParameterServer) as sps:
        with PSClient(*sps.addrs()[0]) as raw:
            assert raw.shard_info == {"index": 0, "num_shards": 2,
                                      "epoch": 0, "digest": sps.plan.digest}
            resp = raw._rpc({"action": "plan"})
            assert resp["ok"] and resp["plan"] == sps.plan.doc()
        with PSClient(*sps.addrs()[1]) as raw:
            assert raw.stats()["shard"]["index"] == 1


def test_plan_mismatch_refused_at_connect():
    c = center_tree()
    with ShardedParameterServer(c, 3, DeltaParameterServer) as sps:
        with pytest.raises(ShardPlanMismatch, match="disagrees"):
            ShardedPSClient(sps.addrs()[:2], c)
    with ShardedParameterServer(c, 2, DeltaParameterServer, epoch=1) as sps:
        with pytest.raises(ShardPlanMismatch, match="disagrees"):
            ShardedPSClient(sps.addrs(), c)
    # a plain (un-sharded) server does not speak the shard protocol
    ps = DeltaParameterServer(center_tree(), num_workers=1)
    with SocketParameterServer(ps) as server:
        with pytest.raises(ShardPlanMismatch, match="shard protocol"):
            ShardedPSClient([("127.0.0.1", server.port)], c,
                            wire_version=1)


def test_v1_interop_verifies_via_plan_rpc():
    c = center_tree((64, 32))
    with ShardedParameterServer(c, 2, DeltaParameterServer) as sps:
        with ShardedPSClient(sps.addrs(), c, wire_version=1) as cl:
            assert cl.wire_version == 1
            assert all(sub.shard_info is None for sub in cl.clients)
            assert cl.commit(ones_like_center((64, 32)))
            tree, _ = cl.pull()
            np.testing.assert_allclose(tree["params"][0]["w"][:3], 1.0)
        # a v2 client beside it reads the same center
        with ShardedPSClient(sps.addrs(), c) as cl:
            assert cl.wire_version == 2
            tree, _ = cl.pull()
            np.testing.assert_allclose(tree["params"][1]["w"][:3], 1.0)


# -- across packages ---------------------------------------------------------------

def _commit_sequence(fleet_cls, server_mod, client_cls, codec):
    """3 shards of ADAG (2 workers): each worker commits 3 seeded deltas;
    returns the final center a client pulls, its counter and the merged
    stats' per-worker commits."""
    c = center_tree((300, 200, 100, 50))
    rng = np.random.default_rng(7)
    deltas = [{"params": [{"w": rng.normal(size=n).astype(np.float32)}
                          for n in (300, 200, 100, 50)],
               "state": [{}, {}, {}, {}]} for _ in range(6)]
    with fleet_cls(c, 3, server_mod.ADAGParameterServer,
                   num_workers=2) as sps:
        with client_cls(sps.addrs(), c, worker_id=0, codec=codec) as a, \
                client_cls(sps.addrs(), c, worker_id=1, codec=codec) as b:
            for i, d in enumerate(deltas):
                assert (a if i % 2 == 0 else b).commit(d)
            tree, updates = a.pull()
            stats = b.stats()
    return tree, updates, stats["commits_by_worker"]


@pytest.mark.parametrize("codec", ["none", "bf16"])
@pytest.mark.parametrize("server,client", [("jax", "port"),
                                           ("port", "jax")])
def test_centers_bit_identical_across_packages(server, client, codec):
    """A port client against the JAX fleet, and a JAX client against the
    port's: the center equals the JAX pair's bit for bit after the same
    commits (the bf16 codec: both packages encode and decode alike)."""
    pkgs = {"jax": (jshard.ShardedParameterServer, jservers,
                    jshard.ShardedPSClient),
            "port": (ShardedParameterServer, port_servers,
                     ShardedPSClient)}
    ref, ref_n, ref_by = _commit_sequence(*pkgs["jax"][:2], pkgs["jax"][2],
                                          codec)
    got, n, by = _commit_sequence(pkgs[server][0], pkgs[server][1],
                                  pkgs[client][2], codec)
    assert n == ref_n == 18 and by == ref_by == {0: 3, 1: 3}
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


# -- the consistent-cut contract ---------------------------------------------

def test_consistent_cut_under_concurrent_commits():
    """One client commits (each adds 1.0 to every leaf, so a valid cut
    has one value across the whole center) while another pulls: every
    assembled center is untorn."""
    c, delta, n_commits = center_tree(), ones_like_center(), 40
    creg, stop = Registry(), threading.Event()
    errors, cuts = [], []
    with ShardedParameterServer(c, 2, DeltaParameterServer,
                                num_workers=2) as sps:
        def committer():
            try:
                with ShardedPSClient(sps.addrs(), c, worker_id=0) as cl:
                    for _ in range(n_commits):
                        assert cl.commit(delta)
            except BaseException as e:
                errors.append(e)
            finally:
                stop.set()

        def puller():
            try:
                with ShardedPSClient(sps.addrs(), c, worker_id=1,
                                     registry=creg) as cl:
                    while not stop.is_set():
                        tree, _ = cl.pull()
                        vals = {float(leaf["w"][0])
                                for leaf in tree["params"]}
                        assert len(vals) == 1, f"torn pull: {vals}"
                        cuts.append(vals.pop())
            except BaseException as e:
                errors.append(e)

        ts = [threading.Thread(target=committer),
              threading.Thread(target=puller)]
        [t.start() for t in ts]
        [t.join(120) for t in ts]
        assert not any(t.is_alive() for t in ts)
    assert not errors, errors
    assert cuts and max(cuts) <= n_commits
    for leaf in sps.get_model()["params"]:
        np.testing.assert_allclose(leaf["w"], n_commits)
    snap = creg.snapshot()
    assert snap["ps.shard.pull_rounds"]["value"] >= len(cuts)
    assert snap.get("ps.shard.cut_incomplete", {}).get("value", 0) == 0


def test_dynsgd_staleness_and_codec_state_are_per_shard(rng):
    c = center_tree((8, 4))
    with ShardedParameterServer(c, 2, DynSGDParameterServer,
                                num_workers=1) as sps:
        with ShardedPSClient(sps.addrs(), c) as cl:
            _, seen = cl.pull()
            assert cl.commit(ones_like_center((8, 4)), last_update=seen)
            # without a fresh pull each shard is one update ahead of the
            # per-shard counter the client resolved: delta / 2
            assert cl.commit(ones_like_center((8, 4)), last_update=seen)
            tree, _ = cl.pull()
            np.testing.assert_allclose(tree["params"][0]["w"], 1.5)
            np.testing.assert_allclose(tree["params"][1]["w"], 1.5)
    for ps in sps.shards:
        assert list(ps.staleness_seen) == [0, 1]

    c = center_tree((600, 300))
    with ShardedParameterServer(c, 2, DeltaParameterServer) as sps:
        with ShardedPSClient(sps.addrs(), c, codec="int8") as cl:
            assert cl.clients[0].codec is not cl.clients[1].codec
            g = {"params": [{"w": rng.normal(size=600).astype(np.float32)},
                            {"w": rng.normal(size=300).astype(np.float32)}],
                 "state": [{}, {}]}
            for _ in range(30):
                cl.commit(g)
            tree, _ = cl.pull()
            # error feedback per shard: the decoded sum tracks the raw
            # sum within about one step's residual on every leaf
            for i in (0, 1):
                drift = np.max(np.abs(np.asarray(tree["params"][i]["w"])
                                      - 30 * g["params"][i]["w"]))
                assert drift < 1.5 * np.max(np.abs(g["params"][i]["w"]))
    for ps in sps.shards:
        assert ps.registry.snapshot()["ps.codec.decode_seconds"][
            "count"] == 30


# -- drops ---------------------------------------------------------------------------

def test_partial_drop_is_repaired():
    c, calls = center_tree(), {"n": 0}

    def drop_first_slice(action, msg):
        if action != "commit":
            return False
        calls["n"] += 1
        return calls["n"] == 1

    reg = Registry()
    with ShardedParameterServer(c, 3, DeltaParameterServer, num_workers=1,
                                fault_injector=drop_first_slice) as sps:
        with ShardedPSClient(sps.addrs(), c, registry=reg) as cl:
            assert cl.commit(ones_like_center())
            tree, _ = cl.pull()
    snap = reg.snapshot()
    assert snap["ps.shard.commit_repairs"]["value"] == 1
    for leaf in tree["params"]:
        np.testing.assert_allclose(leaf["w"], 1.0)
    assert snap.get("ps.shard.torn_pulls", {}).get("value", 0) == 0
    assert snap.get("ps.shard.cut_incomplete", {}).get("value", 0) == 0
    # every shard's accounting holds: requests == applied + dropped
    for ps in sps.shards:
        s = ps.registry.snapshot()
        assert s["ps.commit_requests"]["value"] == \
            s["ps.commits"]["value"] + s["ps.commits_dropped"]["value"]


def test_permanent_drop_gives_up_bounded():
    c = center_tree()

    def drop_shard0_always(action, msg):
        return action == "commit" and "params/0/w" in (msg.get("delta")
                                                       or {})

    reg = Registry()
    with ShardedParameterServer(c, 3, DeltaParameterServer, num_workers=1,
                                fault_injector=drop_shard0_always) as sps:
        with ShardedPSClient(sps.addrs(), c, registry=reg) as cl:
            assert cl.commit(ones_like_center()) is False
            tree, _ = cl.pull()
    snap = reg.snapshot()
    assert snap["ps.shard.commit_repairs"]["value"] == 2   # budget spent
    assert snap["ps.shard.cut_incomplete"]["value"] == 1
    np.testing.assert_allclose(tree["params"][0]["w"], 0.0)
    np.testing.assert_allclose(tree["params"][1]["w"], 1.0)


def test_full_drop_is_a_clean_lost_update():
    c, reg = center_tree(), Registry()
    with ShardedParameterServer(c, 3, DeltaParameterServer, num_workers=1,
                                fault_injector=lambda a, m: a == "commit") \
            as sps:
        with ShardedPSClient(sps.addrs(), c, registry=reg) as cl:
            assert cl.commit(ones_like_center()) is False
            tree, n = cl.pull()
    assert reg.snapshot()["ps.shard.commit_repairs"]["value"] == 0
    assert n == 0
    for leaf in tree["params"]:
        np.testing.assert_allclose(leaf["w"], 0.0)


# -- fleet lifecycle through the facade -------------------------------------------

def test_eviction_fans_out_and_tombstones_everywhere():
    c = center_tree((8, 4))
    with ShardedParameterServer(c, 2, DeltaParameterServer,
                                num_workers=1) as sps:
        with ShardedPSClient(sps.addrs(), c, worker_id=0) as cl:
            assert cl.commit(ones_like_center((8, 4)))
            assert sps.evict_worker(0) == 1
            with pytest.raises(WorkerEvicted):
                cl.commit(ones_like_center((8, 4)))
        assert sps.num_updates == 1
        assert all(ps.generations[0] == 1 for ps in sps.shards)
        tomb = sum(ps.registry.snapshot()["ps.commits_tombstoned"]["value"]
                   for ps in sps.shards)
        assert tomb >= 1
        start, gen = sps.register_respawn(0)
        assert (start, gen) == (1, 1)
        with ShardedPSClient(sps.addrs(), c, worker_id=0,
                             generation=gen) as cl2:
            assert cl2.commit(ones_like_center((8, 4)))
        assert sps.commits_by_worker[0] == 2
        st = sps.stats()
        assert st["commits_by_worker"] == {0: 2}
        assert [s["shard"] for s in st["shards"]] == [0, 1]


def test_dead_shard_raises_named_fleet_error():
    sps = ShardedParameterServer(center_tree((8, 4)), 2,
                                 DeltaParameterServer).start()
    try:
        sps.raise_if_unhealthy()
        sps.servers[1].stop()   # the shard dies outside the facade's stop
        with pytest.raises(ShardFleetError) as ei:
            sps.raise_if_unhealthy()
        assert "shard 1/2" in str(ei.value)
        assert "last commit counter" in str(ei.value)
    finally:
        sps.stop()
    sps.raise_if_unhealthy()   # an intentional stop is no incident


def test_dead_shard_fails_the_training_run(toy):
    """A shard dying mid-run fails ``train()`` with the shard named: the
    supervisor's shard watch raises while worker 0 is stalled after its
    first window."""
    t = dkt.DOWNPOUR(_port_of(_jax_mlp()), "sgd", num_workers=1,
                     ps_shards=2, num_epoch=2, device="cpu", **COMMON)
    out: dict = {}

    def run():
        try:
            t.train(toy[1])
        except BaseException as e:
            out["err"] = e

    with chaos.ThreadStall(workers_mod.PullCommitWorker, worker_id=0,
                           stall_after=1) as stall:
        th = threading.Thread(target=run, daemon=True)
        th.start()
        assert stall.wait_stalled(120)
        _wait(lambda: t._supervisor is not None, 60, "the supervisor")
        t._supervisor.ps.servers[0].stop()   # the shard vanishes mid-run
        th.join(60)
    assert not th.is_alive(), "training never surfaced the dead shard"
    assert isinstance(out.get("err"), ShardFleetError), out.get("err")
    assert "shard 0/2" in str(out["err"])


def test_process_shard_fleet_end_to_end():
    """One shard-server process per shard (``shard_main``), ports from
    port files, plan agreement over the wire, stats per shard; a JAX
    client agrees with the port's shard processes too."""
    c = center_tree((512, 256))
    with ProcessShardFleet(c, 2, ps_class="adag", num_workers=2) as fleet:
        with ShardedPSClient(fleet.addrs(), c, worker_id=0) as cl:
            cl.pull()
            assert cl.commit(ones_like_center((512, 256)))
            tree, updates = cl.pull()
            np.testing.assert_allclose(tree["params"][0]["w"][:3], 0.5)
            assert updates == 2   # one logical commit, once per shard
            st = cl.stats()
            assert st["num_updates"] == 1
            assert st["plan"]["digest"] == cl.plan.digest
            assert "ps.lock_wait_seconds" in st["stats"]
            assert merge_fleet_stats(st["shards"])["commits_by_worker"] \
                == {0: 1}
        with jshard.ShardedPSClient(fleet.addrs(), c, worker_id=1) as jc:
            tree, _ = jc.pull()
            np.testing.assert_allclose(tree["params"][1]["w"][:3], 0.5)


# -- trainer integration --------------------------------------------------------

def test_ps_shards_2_bit_identical_to_single_server_and_near_jax(toy):
    """One deterministic worker trains bit-identical parameters on one
    server and on two shards, and the sharded run is the JAX package's
    within the sync trainers' bound."""
    def run(shards, placement="threads"):
        t = dkt.DOWNPOUR(_port_of(_jax_mlp()), "sgd", num_workers=1,
                         ps_shards=shards, num_epoch=2, device="cpu",
                         async_workers=placement, **COMMON)
        t.train(toy[1])
        return t

    one, two = run(1), run(2)
    a = jax.tree_util.tree_leaves(one.trained_variables)
    b = jax.tree_util.tree_leaves(two.trained_variables)
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
    # a process worker is handed the shard ports as a list, builds its
    # own plan and client, and trains the same bits
    c = jax.tree_util.tree_leaves(run(2, "processes").trained_variables)
    for x, y in zip(c, b):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
    assert two.ps_stats["commits_by_worker"] == {0: 8}
    jt = dk.DOWNPOUR(_jax_mlp(), "sgd", num_workers=1, ps_shards=2,
                     num_epoch=2, **COMMON)
    jt.train(toy[0])
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jt.trained_variables)]
    for x, y in zip(b, ref):
        x = np.asarray(x, np.float64)
        bound = 1e-6 * float(np.max(np.abs(y))) + 1e-5 * np.abs(y)
        assert bool(np.all(np.abs(x - y) <= bound))
    for x, y in zip(two.get_history(), jt.get_history()):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)


def test_two_process_workers_over_two_shards(toy):
    """Two process workers (``async_workers="processes"``) over 2 shards:
    every window commits once on every shard, the accounting holds per
    shard and merged, both workers' records fold and the loss falls."""
    t = dkt.DOWNPOUR(_port_of(_jax_mlp()), "sgd", num_workers=2,
                     ps_shards=2, num_epoch=2, device="cpu",
                     async_workers="processes", **COMMON)
    t.train(toy[1])
    assert t.ps_stats["commits_by_worker"] == {0: 4, 1: 4}
    for snap in t.ps_stats["shards"] + [t.ps_stats["registry"]]:
        assert snap["ps.commit_requests"]["value"] == \
            snap["ps.commits"]["value"] + snap["ps.commits_dropped"]["value"] \
            + snap["ps.commits_tombstoned"]["value"]
    assert [s["ps.commits"]["value"] for s in t.ps_stats["shards"]] == [8, 8]
    recs = [r for r in t.metrics.records if r["event"] == "kernel_launches"]
    assert sorted(r["worker_id"] for r in recs) == [0, 1]
    hist = t.get_averaged_history()
    assert hist[-1] < hist[0]


def test_sharded_dynsgd_trains_with_per_shard_staleness(toy):
    """Two thread workers of DynSGD over 4 shards: every window commits
    once on every shard, each shard records its staleness, the merged
    accounting holds and the loss falls."""
    t = dkt.DynSGD(_port_of(_jax_mlp()), "sgd", num_workers=2,
                   ps_shards=4, num_epoch=2, device="cpu", **COMMON)
    t.train(toy[1])
    assert t.ps_stats["commits_by_worker"] == {0: 4, 1: 4}
    snap = t.ps_stats["registry"]
    assert snap["ps.commits"]["value"] == 4 * 8
    assert snap["ps.commit_requests"]["value"] == \
        snap["ps.commits"]["value"] + snap["ps.commits_dropped"]["value"] \
        + snap["ps.commits_tombstoned"]["value"]
    assert snap["ps.staleness"]["count"] == 4 * 8
    hist = t.get_averaged_history()
    assert hist[-1] < hist[0]


def test_plan_file_is_the_jax_package_s(tmp_path):
    c = center_tree()
    with ShardedParameterServer(c, 2, DeltaParameterServer) as sps:
        sps.write_plan(str(tmp_path / "port.json"))
        with open(tmp_path / "port.json") as f:
            doc = json.load(f)
    ref = jshard.ShardPlan.build(c, 2).doc(addresses=sps.addrs())
    assert doc == json.loads(json.dumps(ref))
