"""The hierarchical two-tier exchange (DESIGN.md §16) in the port against
the JAX package, on the same numpy inputs.

- ``Exchange.streams`` over 8 rounds for both intra tiers (ring, server)
  x both inter tiers (push_sum, server) x ``mix_rounds`` 1 and 2, with and
  without tiered faults, with fp16/bf16 wires and an int8 cross-tier
  codec fed the reference's noise: tolerances of ``test_torch_faults``;
  participation (overall and per tier) and round counters exact; the
  mass invariant (abs 1e-3) every round in both packages.
- ``elect_leaders`` under dropout, a partitioned pod's degraded rounds
  and exact rejoin, the lossless round against a numpy stencil, tiered
  push_sum unbiased where flat gossip drifts.
- The refusals and the per-tier wire bytes (integer-equal), the tier
  pricing of ``AdaptiveT``, and a mid-fault checkpoint resume with
  queued cross-pod mass, bit-exact with the uninterrupted run.
"""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.comm.exchange import elect_leaders as jelect
from repro.core.controller import AdaptiveT as JAdaptiveT
from repro_torch import comm
from repro_torch.comm import faults, topology
from repro_torch.comm.exchange import elect_leaders
from repro_torch.core.controller import AdaptiveT
from test_torch_faults import (FP32, _leaves, assert_round_metrics,
                               assert_same_refusals_and_wire, hook,
                               packed_runs, run_streams_pair)
from test_torch_push_sum import check_mass, mass_total, mix_iter

G = 8


def _cells():
    cells = []
    for intra, inter, mix, faulty in itertools.product(
            ("ring", "server"), ("push_sum", "server"), (1, 2),
            (False, True)):
        kw = dict(intra_topology=intra, inter_topology=inter,
                  mix_rounds=mix, n_pods=4 if mix == 1 else 2)
        codec = "fp32"
        if faulty:
            kw.update(intra_drop_rate=0.1, intra_stall_rate=0.05)
            if inter == "push_sum":
                kw.update(drop_rate=0.2, stall_rate=0.1,
                          dropouts=((2, 1, 4),))
        if inter == "server" and mix == 1:
            kw["inter_codec"] = "int8"         # the cross-tier int8 cell
        elif inter == "push_sum" and faulty and mix == 2:
            kw["inter_codec"] = "fp16"
        if intra == "server" and faulty:
            codec = "bf16"
        cells.append((codec, kw))
    return cells


@pytest.mark.parametrize("codec,kw", _cells())
def test_hierarchical_streams_match_reference(codec, kw):
    port = comm.get_exchange("hierarchical", codec, G, fault_seed=5, seed=3,
                             noise_hook=hook, **kw)
    ref = jcomm.get_exchange("hierarchical", codec, G, fault_seed=5, seed=3,
                             impl="jnp", **kw)
    assert (port.name, port.stateful, port.delivery_rate,
            port.delivery_rate_intra, port.delivery_rate_inter) == (
        ref.name, ref.stateful, ref.delivery_rate, ref.delivery_rate_intra,
        ref.delivery_rate_inter)
    assert [port.lossy_stream(s) for s in ("params", "m")] == [
        ref.lossy_stream(s) for s in ("params", "m")]
    check = None
    if kw["inter_topology"] == "push_sum":
        check = check_mass(G)
    elif "inter_codec" in kw:
        def check(ps, js):
            assert int(ps["codec"]["inter:params"]["count"]) == int(
                js["codec"]["inter:params"]["count"])
    run_streams_pair(port, ref, G, 8, streams=("params", "m"), check=check)


def _ref_hier_round(x, n_pods, mix_rounds=1):
    """One lossless fp32 round (ring intra, push_sum inter) in float64
    numpy: pod-local circulant hops, then one pod-graph hop."""
    g = x.shape[0]
    s = g // n_pods
    y = x.astype(np.float64)

    def pod_take(v, d):
        return np.roll(v.reshape(n_pods, s, -1), -d, axis=1).reshape(v.shape)

    if s > 1:
        w_self, offs, w_edge = topology.ring_circulant(s)
        for _ in range(mix_rounds):
            y = w_self * y + sum(w_edge * pod_take(y, d) for d in offs)
    offs_p = topology.push_sum_offsets(n_pods)
    if offs_p:
        a = 1.0 / (len(offs_p) + 1)
        y = a * y + sum(a * np.roll(y, dp * s, axis=0) for dp in offs_p)
    return y


@pytest.mark.parametrize("g,n_pods,mix_rounds", [
    (4, 2, 1), (8, 2, 2), (8, 4, 1), (6, 3, 1), (6, 1, 1), (6, 6, 1)])
def test_lossless_round_matches_numpy_stencil(g, n_pods, mix_rounds):
    x = np.random.RandomState(g + n_pods).randn(g, 24).astype(np.float32)
    ex = comm.get_exchange("hierarchical", "fp32", g, n_pods=n_pods,
                           mix_rounds=mix_rounds)
    out, st = mix_iter(ex, torch.tensor(x), 1)
    np.testing.assert_allclose(out.numpy(), _ref_hier_round(x, n_pods,
                                                            mix_rounds),
                               **FP32)
    np.testing.assert_allclose(out.numpy().mean(0), x.mean(0), **FP32)
    if "mass" in st:
        np.testing.assert_allclose(st["mass"].numpy(), 1.0, rtol=1e-6)
        assert float(st["backlog_w"].sum()) == 0.0


def test_server_server_is_the_global_mean():
    x = np.random.RandomState(1).randn(8, 16).astype(np.float32)
    ex = comm.get_exchange("hierarchical", "fp32", 8, n_pods=4,
                           intra_topology="server", inter_topology="server")
    out, _ = mix_iter(ex, torch.tensor(x), 1)
    np.testing.assert_allclose(out.numpy(), np.broadcast_to(x.mean(0),
                                                            x.shape), **FP32)


def test_mass_conserved_and_unbiased_under_dcn_loss():
    x = np.random.RandomState(2).randn(G, 40).astype(np.float32)
    ex = comm.get_exchange("hierarchical", "fp32", G, n_pods=4,
                           drop_rate=0.2, stall_rate=0.1, fault_seed=5)
    masses = []
    out, _ = mix_iter(ex, torch.tensor(x), 60,
                      lambda st: masses.append(mass_total(st)))
    assert all(m == pytest.approx(G, abs=1e-3) for m in masses)
    assert np.abs(out.numpy() - x.mean(0)).max() < 1e-3
    assert np.abs(out.numpy().mean(0) - x.mean(0)).max() < 1e-4


def test_tiered_push_sum_unbiased_where_flat_gossip_drifts():
    """7.5% DCN loss on the tiers against the same loss on flat gossip
    (fault seed 2), 40 rounds of numpy-drawn x, in both packages."""
    x = np.random.RandomState(0).randn(G, 40).astype(np.float32)
    errs = {}
    for tag, topo, kw in (("hier", "hierarchical", dict(n_pods=4)),
                          ("gossip", "gossip", {})):
        ex = comm.get_exchange(topo, "fp32", G, drop_rate=0.075,
                               fault_seed=2, **kw)
        jex = jcomm.get_exchange(topo, "fp32", G, drop_rate=0.075,
                                 fault_seed=2, **kw)
        out, st = mix_iter(ex, torch.tensor(x), 40)
        jy, jst = jnp.asarray(x), jex.init(jnp.asarray(x))
        for _ in range(40):
            jy, jst = jex.params(jy, None, jst)
        np.testing.assert_allclose(out.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
        errs[tag] = float(np.linalg.norm(out.numpy().mean(0) - x.mean(0)))
        if tag == "hier":
            assert mass_total(st) == pytest.approx(G, abs=1e-3)
    assert errs["hier"] < 1e-3 and errs["gossip"] > 10 * errs["hier"], errs


@pytest.mark.parametrize("act", [
    [1, 1, 1, 1, 1, 1], [0, 1, 1, 1, 1, 1], [1, 1, 0, 0, 1, 1],
    [0, 0, 0, 0, 0, 0], [0, 1, 0, 1, 1, 0]])
def test_elect_leaders_matches_reference(act):
    act = np.asarray(act, np.float32)
    w, live = elect_leaders(act, 3)
    jw, jlive = jelect(jnp.asarray(act), 3)
    np.testing.assert_array_equal(w, np.asarray(jw))
    np.testing.assert_array_equal(live, np.asarray(jlive))
    # the first live member of each pod leads; a dead pod has none
    for p in range(3):
        pod = act[2 * p:2 * p + 2]
        assert w[2 * p:2 * p + 2].sum() == (1.0 if pod.any() else 0.0)
        if pod.any():
            assert w[2 * p + int(np.argmax(pod))] == 1.0


def test_partitioned_pod_degrades_then_rejoins_exactly():
    """Pod 1 (lanes 2-3) absent from the DCN for rounds [2, 5): its pod
    mean is frozen while it runs local rounds, the mass is conserved
    every round, and after rejoin everyone reaches the true mean."""
    x = np.random.RandomState(4).randn(4, 32).astype(np.float32)
    ex = comm.get_exchange("hierarchical", "fp32", 4, n_pods=2,
                           dropouts=((2, 2, 5), (3, 2, 5)), fault_seed=1)
    st = ex.init(torch.tensor(x))
    y = torch.tensor(x)
    pod1 = None
    for rnd in range(24):
        y, st = ex.params(y, None, st)
        assert mass_total(st) == pytest.approx(4, abs=1e-3), rnd
        cur = y.numpy()[2:4].mean(0)
        if rnd == 2:
            pod1 = cur.copy()
        elif rnd in (3, 4):
            np.testing.assert_allclose(cur, pod1, **FP32)
    np.testing.assert_allclose(y.numpy(), np.broadcast_to(x.mean(0),
                                                          x.shape), atol=1e-3)
    assert np.abs(y.numpy().mean(0) - x.mean(0)).max() < 1e-4


def test_hierarchical_refusals_and_wire_equal_reference():
    """Pod counts x tier topologies x codecs x inter codecs x downlink x
    overlap x fault flags of both tiers: the same refusals (type and
    message), and otherwise the reference's wire bytes by stream, tier
    and direction, integer for integer."""
    grid = [dict(n_pods=p, intra_topology=i, inter_topology=x, codec=c,
                 moment_codec=m, inter_codec=ic, downlink_codec=d,
                 overlap=o, **f)
            for p, i, x, c, m, ic, d, o, f in itertools.product(
                (1, 2, 3, 8), ("ring", "server"), ("push_sum", "server"),
                ("fp32", "bf16", "int8"), ("fp32", "fp16", "int8z"),
                ("", "fp16", "int8", "topk"), ("", "int8"), (False, True),
                ({}, dict(drop_rate=0.1, fault_seed=3),
                 dict(intra_drop_rate=0.2, intra_stall_rate=0.1)))]
    grid += [dict(n_pods=2, intra_topology="mesh"),
             dict(n_pods=2, inter_topology="mesh"), dict(n_pods=0)]
    assert assert_same_refusals_and_wire("hierarchical", grid,
                                         n_groups=8) > 50
    # tier knobs on a flat topology
    for kw in (dict(n_pods=2), dict(inter_codec="int8"),
               dict(intra_drop_rate=0.1)):
        assert assert_same_refusals_and_wire("ring", [kw]) == 0


def test_tier_wire_identity_and_cross_tier_reduction():
    """wire_bytes == intra + inter on every exchange; the int8 cross-tier
    codec cuts the DCN bytes 3.92x at the tier benchmark's D = 400 (12,800
    -> 3,264 bytes) and leaves the intra bytes as they are."""
    f32 = comm.get_exchange("hierarchical", "fp32", 8, n_pods=4,
                            intra_topology="server", inter_topology="server")
    q8 = comm.get_exchange("hierarchical", "fp32", 8, n_pods=4,
                           intra_topology="server", inter_topology="server",
                           inter_codec="int8")
    bf, bq = f32.wire_bytes_by_tier(400), q8.wire_bytes_by_tier(400)
    assert (bf["inter"], bq["inter"], bf["intra"]) == (12_800, 3_264,
                                                      25_600)
    assert bq["intra"] == bf["intra"]
    for ex in (f32, q8, comm.get_exchange("hierarchical", "bf16", 8,
                                          n_pods=2, drop_rate=0.1)):
        tier = ex.wire_bytes_by_tier(1001, {"m": 1001})
        assert ex.wire_bytes_per_round(1001, moment_sizes={"m": 1001}) == (
            tier["intra"] + tier["inter"])


def test_tiered_plan_refusals():
    x = torch.zeros(4, 8)
    ex = comm.get_exchange("hierarchical", "fp32", 4, n_pods=2)
    bad = dataclasses.replace(ex, fault_plan=faults.FaultPlan(drop_rate=0.2))
    with pytest.raises(NotImplementedError, match="TieredFaultPlan"):
        bad.streams({"params": x}, {}, bad.init(x))
    flat = dataclasses.replace(
        comm.get_exchange("ring", "fp32", 4),
        fault_plan=faults.TieredFaultPlan(inter=faults.FaultPlan(
            drop_rate=0.1)))
    with pytest.raises(NotImplementedError, match="single-tier"):
        flat.streams({"params": x}, {}, {})


def test_adaptive_t_prices_tiers_on_their_own_links():
    def r(ex, **kw):
        return AdaptiveT.from_exchange(1e-3, ex, 1_000_000, **kw).r

    def jr(ex, **kw):
        return JAdaptiveT.from_exchange(1e-3, ex, 1_000_000, **kw).r

    for kw in (dict(inter_codec="bf16", drop_rate=0.1),
               dict(inter_codec="bf16"),
               dict(inter_codec="bf16", intra_drop_rate=0.2)):
        ex = comm.get_exchange("hierarchical", "fp32", 4, n_pods=2, **kw)
        jex = jcomm.get_exchange("hierarchical", "fp32", 4, n_pods=2, **kw)
        assert r(ex) == pytest.approx(jr(jex), rel=1e-12)
        assert r(ex, inter_bandwidth_bytes_per_s=5e9) < r(ex)
    lossless = comm.get_exchange("hierarchical", "fp32", 4, n_pods=2,
                                 inter_codec="bf16")
    lossy_ici = comm.get_exchange("hierarchical", "fp32", 4, n_pods=2,
                                  inter_codec="bf16", intra_drop_rate=0.2)
    assert r(lossy_ici) < r(lossless)


@pytest.mark.parametrize("intra,inter,kw", [
    ("ring", "push_sum", dict(drop_rate=0.2, intra_drop_rate=0.1)),
    ("server", "server", dict(inter_codec="int8")),
])
def test_hierarchical_packed_round_matches_reference(intra, inter, kw):
    js, jms, ts, tms, _, _ = packed_runs(
        "hierarchical", "fp32", "sgd", 0.4, 4,
        dict(n_pods=4, intra_topology=intra, inter_topology=inter,
             fault_seed=3, **kw), g=8)
    for jst, tst, jm, tm in zip(js, ts, jms, tms):
        np.testing.assert_allclose(tst["params"].numpy(), jst["params"],
                                   **FP32)
        assert int(tst["comm"]["round"]) == int(jst["comm"]["round"])
        assert_round_metrics(jm, tm)
        assert int(tm["wire_bytes"]) == (int(tm["wire_bytes_intra"])
                                         + int(tm["wire_bytes_inter"]))


def test_checkpoint_resume_mid_fault_tiered_backlogs(tmp_path):
    """Save at round 3 with queued cross-pod mass under both tiers' plans,
    load with ``checkpoint/io``, and 3 more rounds equal the uninterrupted
    run's bit for bit."""
    from repro_torch import bridge
    from repro_torch.checkpoint import io as ckpt_io
    from test_torch_pytree_round import quadratic

    _, _, ts, _, rnd, ex = packed_runs(
        "hierarchical", "fp32", "momentum", 0.05, 3,
        dict(n_pods=2, drop_rate=0.4, stall_rate=0.1, intra_drop_rate=0.1,
             fault_seed=4), ref=False)
    st = ts[-1]
    assert int(st["comm"]["round"]) == 3
    assert float(st["comm"]["backlog_w"].sum()) > 0.0
    assert mass_total(st["comm"]) == pytest.approx(4, abs=1e-3)
    path = str(tmp_path / "mid_fault_tiered")
    ckpt_io.save(path, st, metadata={"round": 3, "comm": ex.name})
    back = ckpt_io.load(path, st)
    tb = bridge.params_from_numpy(quadratic(0)[1])
    for _ in range(3):
        st, _ = rnd(st, tb)
        back, _ = rnd(back, tb)
    for (pa, a), (pb, b) in zip(_leaves(st), _leaves(back)):
        assert pa == pb
        torch.testing.assert_close(a, b, rtol=0, atol=0)
