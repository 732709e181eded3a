"""push_sum ratio consensus (DESIGN.md §12) in the port against the JAX
package, on the same numpy inputs.

- ``Exchange.streams`` over 10 rounds (G 2, 4, 8; fp32, fp16 and bf16
  wires; with and without drops, stalls and a dropout window; one and two
  hops): the mixed streams at rtol 1e-5 / atol 1e-6 (fp32) or up to one
  cast step on at most 10% of the elements (``test_torch_faults``), the
  mass counters at rtol 1e-6, participation and round counters exact.
  The invariant ``sum(mass) + sum(backlog_w) == G`` holds in both
  packages every round to float32 precision (abs 1e-3, the reference's
  own bound).
- The bias cell: under the same 5% masks gossip drifts the mean and
  push_sum does not, in both packages, by the same amounts; elastic
  membership; the cast codecs' deferral.
- Delivered-edge wire pricing and the delivery-rate repricing of
  ``AdaptiveT``; the packed round with push_sum against the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.core.controller import AdaptiveT as JAdaptiveT
from repro_torch import comm, optim
from repro_torch.comm import topology
from repro_torch.core import localsgd as lsgd
from repro_torch.core.controller import AdaptiveT
from test_torch_faults import (FP32, assert_round_metrics, hook, packed_runs,
                               run_streams_pair)
from test_torch_pytree_round import quad_loss_t

G = 4


def mass_total(st):
    return float(np.sum(np.asarray(st["mass"]))
                 + np.sum(np.asarray(st["backlog_w"])))


def check_mass(n_groups):
    def check(ps, js):
        assert mass_total(ps) == pytest.approx(n_groups, abs=1e-3)
        assert mass_total(js) == pytest.approx(n_groups, abs=1e-3)
        np.testing.assert_allclose(ps["mass"].numpy(), np.asarray(js["mass"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(ps["backlog_w"].numpy(),
                                   np.asarray(js["backlog_w"]), rtol=1e-6,
                                   atol=1e-7)
    return check


@pytest.mark.parametrize("g,codec,kw", [
    (4, "fp32", dict(mix_rounds=2, drop_rate=0.1, stall_rate=0.05)),
    (4, "bf16", dict(mix_rounds=1, drop_rate=0.2, moment_codec="fp16")),
    (8, "fp16", dict(mix_rounds=1, stall_rate=0.2, dropouts=((3, 2, 6),))),
    (2, "fp32", dict(mix_rounds=2, drop_rate=0.3)),
    (4, "fp32", dict(mix_rounds=1)),
])
def test_push_sum_streams_match_reference(g, codec, kw):
    port = comm.get_exchange("push_sum", codec, g, fault_seed=2, **kw)
    ref = jcomm.get_exchange("push_sum", codec, g, fault_seed=2, impl="jnp",
                             **kw)
    assert (port.name, port.stateful, port.p2p, port.delivery_rate) == (
        ref.name, ref.stateful, ref.p2p, ref.delivery_rate)
    streams = ("params",) if codec == "fp32" and g == 2 else (
        "params", "m", "v")
    run_streams_pair(port, ref, g, 10, streams=streams, check=check_mass(g))


def mix_iter(ex, x, n_iter, every=None):
    """The exchange as a pure consensus map, params only."""
    st = ex.init(x)
    for _ in range(n_iter):
        x, st = ex.params(x, None, st)
        if every is not None:
            every(st)
    return x, st


def test_push_sum_lossless_converges_to_true_mean():
    x = torch.tensor(np.random.RandomState(0).randn(G, 24).astype(
        np.float32) * 3)
    want = x.mean(0, keepdim=True).expand_as(x).clone()
    ex = comm.get_exchange("push_sum", "fp32", G, mix_rounds=2)
    out, st = mix_iter(ex, x.clone(), 30)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)
    assert mass_total(st) == pytest.approx(G, abs=1e-3)
    assert float(st["participation"]) == 1.0


def test_push_sum_mass_conserved_and_unbiased_under_faults():
    """10% drop + 5% stall: the mass is conserved every round and the
    ratio still converges to the true mean (loss delays mass)."""
    x = torch.tensor(np.random.RandomState(1).randn(G, 24).astype(
        np.float32) * 3)
    want = x.mean(0, keepdim=True).expand_as(x).clone()
    ex = comm.get_exchange("push_sum", "fp32", G, mix_rounds=2,
                           drop_rate=0.1, stall_rate=0.05, fault_seed=1)
    assert ex.faulty and ex.stateful
    parts = []

    def every(st):
        assert mass_total(st) == pytest.approx(G, abs=1e-3)
        parts.append(float(st["participation"]))

    out, st = mix_iter(ex, x.clone(), 40, every)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-4)
    assert all(0.0 < p <= 1.0 for p in parts) and min(parts) < 1.0


def test_push_sum_cast_codec_converges_under_faults():
    """A cast wire's residue stays queued: mass conserved, consensus error
    bounded by the cast precision."""
    x = torch.tensor(np.random.RandomState(2).randn(G, 24).astype(
        np.float32))
    want = x.mean(0, keepdim=True).expand_as(x).clone()
    for codec, tol in (("bf16", 0.05), ("fp16", 0.01)):
        ex = comm.get_exchange("push_sum", codec, G, mix_rounds=2,
                               drop_rate=0.08, stall_rate=0.05, fault_seed=2)
        out, st = mix_iter(ex, x.clone(), 40)
        torch.testing.assert_close(out, want, rtol=0, atol=tol)
        assert mass_total(st) == pytest.approx(G, abs=1e-2)


def test_push_sum_elastic_membership_rejoin():
    """Node 1 absent for rounds [2, 6): its mass waits; after rejoin the
    group converges to the true 4-node mean."""
    x = torch.tensor(np.random.RandomState(3).randn(G, 16).astype(
        np.float32) * 2)
    want = x.mean(0, keepdim=True).expand_as(x).clone()
    ex = comm.get_exchange("push_sum", "fp32", G, dropouts=((1, 2, 6),))
    assert ex.faulty
    out, st = mix_iter(ex, x.clone(), 40)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-4)
    assert mass_total(st) == pytest.approx(G, abs=1e-3)


@pytest.mark.parametrize("topo", ["ring", "gossip"])
def test_lossy_mixing_biases_where_push_sum_does_not(topo):
    """The bias cell (5% drop, fault seed 2, 60 rounds, numpy-drawn x): the
    masked doubly-stochastic hop reaches consensus on a drifted mean,
    push_sum does not drift; both packages land on the same points."""
    x_np = np.random.RandomState(0).randn(G, 20).astype(np.float32) * 3
    mean0 = x_np.mean(0)
    bias = {}
    for t in (topo, "push_sum"):
        ex = comm.get_exchange(t, "fp32", G, drop_rate=0.05, fault_seed=2)
        jex = jcomm.get_exchange(t, "fp32", G, drop_rate=0.05, fault_seed=2)
        out, _ = mix_iter(ex, torch.tensor(x_np), 60)
        jst, jy = jex.init(jnp.asarray(x_np)), jnp.asarray(x_np)
        for _ in range(60):
            jy, jst = jex.params(jy, None, jst)
        np.testing.assert_allclose(out.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
        o = out.numpy()
        bias[t] = float(np.abs(o.mean(0) - mean0).max())
        if t == topo:
            assert float(np.abs(o - o.mean(0)).max()) < 1e-3
    assert bias[topo] > 0.05, bias
    assert bias["push_sum"] < 1e-4, bias
    assert bias[topo] > 1e3 * bias["push_sum"]


def test_push_sum_wire_prices_delivered_edges():
    n = 32
    assert topology.push_sum_offsets(G) == (1, 3)
    assert topology.push_sum_offsets(2) == (1,)
    assert topology.push_sum_offsets(1) == ()
    ex = comm.get_exchange("push_sum", "fp32", G)
    assert ex.wire_bytes_per_round(n) == (4 * n + 4) * 2 * G
    lossy = comm.get_exchange("push_sum", "fp32", G, drop_rate=0.05)
    assert lossy.delivery_rate == pytest.approx(0.95)
    assert lossy.wire_bytes_per_round(n) == int(round(
        (4 * n + 4) * 2 * G * 0.95))
    assert lossy.wire_bytes_by_stream(n)["params"] \
        == lossy.wire_bytes_per_round(n)
    assert "+drop0.05@0" in lossy.name
    # G = 1: no wire, the state passes through
    one = comm.get_exchange("push_sum", "fp32", 1)
    x = torch.ones(1, 5)
    out, st = one.params(x, None, one.init(x))
    assert out is x and int(st["round"]) == 1
    assert one.wire_bytes_per_round(5) == 0


def test_adaptive_t_reprices_by_delivery_rate():
    """r shrinks by the delivery rate on a faulty server; push_sum's
    delivered-edge bytes over the delivery rate equal its attempted
    bytes, so its r is its lossless one; equal to the reference's r."""
    pairs = {}
    for topo, kw in (("server", {}), ("server", dict(drop_rate=0.2)),
                     ("push_sum", {}), ("push_sum", dict(drop_rate=0.25))):
        r = AdaptiveT.from_exchange(1e-3, comm.get_exchange(topo, "fp32", G,
                                                            **kw), 10_000).r
        jr = JAdaptiveT.from_exchange(1e-3, jcomm.get_exchange(
            topo, "fp32", G, **kw), 10_000).r
        assert r == pytest.approx(jr, rel=1e-12)
        pairs[(topo, bool(kw))] = r
    assert pairs[("server", True)] == pytest.approx(
        0.8 * pairs[("server", False)])
    assert pairs[("push_sum", True)] == pytest.approx(
        pairs[("push_sum", False)], rel=1e-4)


@pytest.mark.parametrize("opt_name,codec,kw", [
    ("sgd", "fp32", dict(mix_rounds=2, drop_rate=0.1, stall_rate=0.05)),
    ("adamw", "bf16", dict(drop_rate=0.05, moment_codec="bf16")),
])
def test_push_sum_packed_round_matches_reference(opt_name, codec, kw):
    """4 rounds of the packed round: params, moments and the comm state's
    counters against the reference's jitted round; every metric (the
    backlog mass included), participation exact."""
    lr = {"sgd": 0.4, "adamw": 0.02}[opt_name]
    js, jms, ts, tms, _, _ = packed_runs("push_sum", codec, opt_name, lr, 4,
                                         dict(fault_seed=1, **kw))
    cast = codec != "fp32"
    for jst, tst, jm, tm in zip(js, ts, jms, tms):
        tol = dict(rtol=1e-5, atol=1e-3) if cast else FP32
        np.testing.assert_allclose(tst["params"].numpy(), jst["params"],
                                   **tol)
        np.testing.assert_allclose(tst["comm"]["mass"].numpy(),
                                   np.asarray(jst["comm"]["mass"]), rtol=1e-6)
        assert mass_total(tst["comm"]) == pytest.approx(G, abs=1e-3)
        assert_round_metrics(jm, tm, tol=dict(rtol=1e-3, atol=1e-5)
                             if cast else FP32)


def test_round_refuses_missing_push_sum_state():
    from test_torch_pytree_round import quadratic

    from repro_torch import bridge
    from repro_torch.optim import packing

    params, batch = quadratic(0)
    tp = bridge.params_from_numpy(params)
    layout, opt = packing.layout_of(tp), optim.packed("sgd", 0.1)
    cfg = lsgd.LocalSGDConfig(n_groups=G, inner_steps=1)
    tb = bridge.params_from_numpy(batch)
    for ex, match in ((comm.get_exchange("push_sum", "fp32", G), "mass"),
                      (comm.get_exchange("server", "fp32", G,
                                         drop_rate=0.2), "pushed")):
        rnd = lsgd.make_local_round(quad_loss_t, opt, cfg, layout=layout,
                                    exchange=ex)
        st = lsgd.init_state(tp, opt, G, layout)
        with pytest.raises(ValueError, match="init_state"):
            rnd(st, tb)
        st["comm"] = {"round": torch.zeros((), dtype=torch.int32)}
        with pytest.raises(ValueError, match=match):
            rnd(st, tb)
    # the pytree round takes push_sum and faults, and refuses a state
    # built without their comm state in the same way
    tree_st = lsgd.init_state(tp, optim.sgd(0.1), G)
    for ex, match in ((comm.get_exchange("push_sum", "fp32", G), "mass"),
                      (comm.get_exchange("server", "fp32", G,
                                         drop_rate=0.2), "pushed")):
        rnd = lsgd.make_local_round(quad_loss_t, optim.sgd(0.1), cfg,
                                    exchange=ex)
        with pytest.raises(ValueError, match="init_state"):
            rnd(tree_st, tb)
        with pytest.raises(ValueError, match=match):
            rnd({**tree_st, "comm": {"round": torch.zeros(
                (), dtype=torch.int32)}}, tb)


def test_hook_is_unused_by_cast_wires():
    """push_sum takes no int8 codec (the reference's refusal), so the
    noise hook never reaches it."""
    with pytest.raises(NotImplementedError, match="valid push_sum codecs"):
        comm.get_exchange("push_sum", "int8", G, noise_hook=hook)
