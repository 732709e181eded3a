"""The port's sharded exchange under faults and with top-k against the
JAX package, mirroring ``tests/test_exchange_engine.py:458-552`` and
``tests/test_faults.py:644-712``.

One world of 8 gloo CPU ranks (G 4 x S 2) runs every cell
(``_torch_shard_cells``); rank 0 returns the buffers gathered to (G, Np):

- sharded top-k (a threshold selection, DESIGN.md §11): at most k entries
  a group, never the zero pad, the error-feedback identity ``c == d_hat +
  residual`` exact, every shipped entry at least every kept one; on a
  ring it contracts the disagreement;
- the zero pad is a fixed point of the ring and gossip hops;
- one faulty exchange each of push_sum (fp32, bf16), server top-k,
  gossip and async_stale int8 against the reference's ``streams`` on the
  same masks: push_sum bit-equal to the port's replicated exchange (the
  same ops, point to point) and within 1e-5 of the reference; the others
  within rtol 1e-5 / atol 1e-6 (top-k: 98% of the elements, atol 0.05
  for the near-threshold sliver, as the reference holds its own);
  participation, the round counter and push-sum's mass exact;
- push_sum over 8 faulty rounds: every round within 1e-5 of the
  reference, the mass conserved to 1e-3;
- faulty server, ring and gossip rounds against the reference's
  replicated round, within 1e-5 relative;
- top-k on the ``cuda-ipc`` transport's mailboxes (file mappings on the
  CPU): the same selection as the gloo world's (tau from a MAX and an
  integer SUM, exact on either transport);
- the two-tier exchange (``tests/test_hierarchical.py:491-560``, G 4 in
  2 pods): the reference's three cells against its replicated
  ``streams`` (within 1e-5 of the stream's largest element, the three
  participations and the round exact, the mass within 1e-6), the
  pod-internal hop bit-equal under ``ppermute`` and ``allgather``, 6
  faulty rounds conserving the mass to 1e-3 in both packages;
- the overlapped packed round (``tests/test_overlap.py:620``): 3 sharded
  rounds of server int8 and ring int8z against the reference's
  replicated overlap round, params and ``inflight`` within rtol 1e-5 /
  atol 1e-6, wire bytes equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_shard_cells as C
from repro import comm as jcomm
from repro_torch import comm, tree
from repro_torch.optim import packing
from test_torch_shardexec import noise_table, ref_round, rel_err

G = C.G

FAULTY = [
    ("push_sum", "fp32", dict(mix_rounds=2, drop_rate=0.05), True),
    ("push_sum", "bf16", dict(mix_rounds=1, drop_rate=0.08,
                              stall_rate=0.05), True),
    ("server", "topk", dict(drop_rate=0.2), False),
    ("gossip", "fp32", dict(mix_rounds=2, drop_rate=0.05,
                            stall_rate=0.1), False),
    ("async_stale", "int8", dict(staleness=1, drop_rate=0.15), False),
]
PUSH8 = dict(mix_rounds=2, drop_rate=0.1, stall_rate=0.05, fault_seed=3)
# the reference's sharded two-tier cells (tests/test_hierarchical.py:491)
HIER = {
    "ring-push_sum-fp32": ("fp32", dict(drop_rate=0.3, stall_rate=0.1,
                                        intra_drop_rate=0.05)),
    "ring-push_sum-bf16": ("bf16", dict(drop_rate=0.08, stall_rate=0.05,
                                        inter_codec="bf16")),
    "server-server-int8": ("fp32", dict(intra_topology="server",
                                        inter_topology="server",
                                        inter_codec="int8",
                                        intra_stall_rate=0.1)),
}
HIER6 = dict(n_pods=2, drop_rate=0.2, stall_rate=0.1, fault_seed=3)
OVERLAP = {f"overlap-{t}-{c}": dict(kind="round", opt="sgd", lr=0.3, T=4,
                                    topo=t, codec=c, ex=dict(overlap=True))
           for t, c in (("server", "int8"), ("ring", "int8z"))}
ROUNDS = {
    "round-server": dict(kind="round", opt="sgd", T=2, rounds=4,
                         metrics="final",
                         ex=dict(drop_rate=0.2, fault_seed=1)),
    "round-ring": dict(kind="round", opt="momentum", topo="ring",
                       codec="int8", T=2, rounds=3, metrics="final",
                       ex=dict(mix_rounds=2, drop_rate=0.1, stall_rate=0.1,
                               fault_seed=2)),
    "round-gossip": dict(kind="round", opt="adamw", topo="gossip", T=2,
                         rounds=3, metrics="final",
                         ex=dict(drop_rate=0.05, stall_rate=0.1,
                                 fault_seed=1)),
}


def packed_setup(seed=1, scale=0.1):
    """(layout, x0, x): replicated params packed on the sharded layout,
    x perturbed on the real elements only (the pad stays zero)."""
    params, _ = C.problem()
    layout = C.sharded_layout(params, 2)
    x0 = np.asarray(packing.pack(tree.tree_map(
        lambda a: torch.as_tensor(a)[None].repeat(G, *([1] * a.ndim)),
        params), layout))
    x = x0 + (np.random.RandomState(seed).randn(*x0.shape)
              * scale).astype(np.float32)
    x[:, layout.size:] = 0.0
    return layout, x0, x


def _cells():
    layout, x0, x = packed_setup()
    _, x0b, xb = packed_setup(scale=1.0)
    cells = {
        "topk": dict(kind="exchange", codec="topk",
                     ex=dict(topk_frac=0.02), xs={"params": x},
                     xs0={"params": x0}, init={"params": x0}),
        "topk-ring": dict(kind="exchange", topo="ring", codec="topk",
                          ex=dict(mix_rounds=4, topk_frac=0.25),
                          xs={"params": xb}, xs0={"params": x0b}),
        "pad-ring": dict(kind="mix", topo="ring", ex=dict(mix_rounds=4),
                         x=xb),
        "pad-gossip": dict(kind="mix", topo="gossip",
                           ex=dict(mix_rounds=4), x=xb),
        "push8": dict(kind="exchange", topo="push_sum", ex=PUSH8,
                      rounds=8, xs={"params": x}, xs0={},
                      init={"params": x0}),
    }
    for topo, codec, kw, _ in FAULTY:
        cells[f"faulty-{topo}-{codec}"] = dict(
            kind="exchange", topo=topo, codec=codec,
            ex=dict(kw, fault_seed=6), xs={"params": x},
            init={"params": x0},
            xs0={} if codec == "fp32" else {"params": x0})
    cells.update(ROUNDS)
    cells["mailbox-topk"] = dict(cells["topk"], mailbox=True)
    for name, (codec, kw) in HIER.items():
        ex = dict(kw, n_pods=2, fault_seed=6)
        lossy = comm.get_exchange("hierarchical", codec, G,
                                  **ex).lossy_stream("params")
        cells[f"hier-{name}"] = dict(
            kind="exchange", topo="hierarchical", codec=codec, ex=ex,
            xs={"params": x}, init={"params": x0},
            xs0={"params": x0} if lossy else {})
    cells["hier-allgather"] = dict(cells["hier-ring-push_sum-fp32"],
                                   hop_impl="allgather")
    cells["hier6"] = dict(kind="exchange", topo="hierarchical", ex=HIER6,
                          rounds=6, xs={"params": x}, xs0={},
                          init={"params": x0})
    cells.update(OVERLAP)
    return cells


@pytest.fixture(scope="module")
def world():
    noise = noise_table(lanes=("params", "moments", "inter"))
    out = C.run_in_background(_cells(), noise)
    refs = {name: ref_round(cell) for name, cell in {**ROUNDS,
                                                     **OVERLAP}.items()}
    got = out()
    got["refs"] = refs
    got["noise"] = noise
    return got


def mass_total(st):
    return float(np.sum(st["mass"]) + np.sum(st["backlog_w"]))


def test_sharded_topk_selection_properties(world):
    """At most k entries a group, never the pad, the EF identity exact,
    every shipped |entry| at least every kept one."""
    layout, x0, x = packed_setup()
    got = world["topk"][0]
    res = got["state"]["codec"]["params"]["residual"]
    c = x - x0
    d_hat = c - res
    k = max(1, round(0.02 * layout.padded))
    assert k < layout.size
    nsel = (d_hat != 0).sum(axis=1)
    assert (nsel <= k).all() and (nsel >= 1).all(), (nsel, k)
    np.testing.assert_array_equal(d_hat[:, layout.size:], 0.0)
    np.testing.assert_array_equal(res[:, layout.size:], 0.0)
    for g in range(G):
        shipped = np.abs(d_hat[g][d_hat[g] != 0])
        kept = np.abs(res[g][(d_hat[g] == 0) & (c[g] != 0)])
        if shipped.size and kept.size:
            assert shipped.min() >= kept.max()
    # the server mean of what shipped, on every group
    want = (x0 + d_hat).mean(axis=0, keepdims=True)
    np.testing.assert_allclose(got["mixed"]["params"],
                               np.broadcast_to(want, x.shape),
                               rtol=1e-6, atol=1e-7)


def test_mailbox_topk_selects_as_gloo(world):
    """The mailboxes' MAX and integer SUM give the gloo world's tau: the
    same entries ship, the residuals bit-equal, the mean within rtol
    1e-6 (its float SUM runs in member order)."""
    a, b = world["mailbox-topk"][0], world["topk"][0]
    np.testing.assert_array_equal(a["state"]["codec"]["params"]["residual"],
                                  b["state"]["codec"]["params"]["residual"])
    np.testing.assert_allclose(a["mixed"]["params"], b["mixed"]["params"],
                               rtol=1e-6, atol=1e-7)


def test_sharded_topk_ring_runs_and_contracts(world):
    layout, _, x = packed_setup(scale=1.0)
    got = world["topk-ring"][0]
    o = got["mixed"]["params"]
    assert np.isfinite(o).all()
    dis_in = float(np.abs(x - x.mean(0)).max())
    dis_out = float(np.abs(o - o.mean(0)).max())
    assert dis_out < 0.9 * dis_in
    np.testing.assert_array_equal(
        got["state"]["codec"]["params"]["residual"][:, layout.size:], 0.0)


@pytest.mark.parametrize("topo", ["ring", "gossip"])
def test_ppermute_pad_is_fixed_point(world, topo):
    layout, _, _ = packed_setup()
    out = world[f"pad-{topo}"]
    np.testing.assert_array_equal(out[:, layout.size:], 0.0)
    assert np.abs(out[:, :layout.size]).max() > 0


@pytest.mark.parametrize("topo,codec,kw,exact", FAULTY,
                         ids=[f"{t}-{c}" for t, c, _, _ in FAULTY])
def test_sharded_faulty_exchange_matches_replicated(world, topo, codec, kw,
                                                    exact):
    """The masks are made on the host at full shape, identical on every
    rank and to the reference's: the sharded exchange consumes the same
    fault schedule."""
    layout, x0, x = packed_setup()
    got = world[f"faulty-{topo}-{codec}"][0]
    ex = jcomm.get_exchange(topo, codec, G, impl="jnp", fault_seed=6, **kw)
    xs = {"params": jnp.asarray(x)}
    xs0 = {} if codec == "fp32" else {"params": jnp.asarray(x0)}
    out_r, st_r = jax.jit(ex.streams)(xs, xs0, ex.init(jnp.asarray(x0)))
    a, b = got["mixed"]["params"], np.asarray(out_r["params"])
    ss = got["state"]
    if codec == "topk":
        close = np.abs(a - b) <= 1e-5 + 1e-5 * np.abs(b)
        assert close.mean() > 0.98, close.mean()
        np.testing.assert_allclose(a, b, atol=0.05)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert float(ss["participation"]) == pytest.approx(
        float(st_r["participation"]))
    assert int(ss["round"]) == int(st_r["round"]) == 1
    if exact:
        # the port's replicated push-sum: the same ops, bit for bit
        pex = comm.get_exchange(topo, codec, G, fault_seed=6, **kw)
        st0 = pex.init(torch.as_tensor(x0))
        out_p, st_p = pex.streams({"params": torch.as_tensor(x)}, {}, st0)
        np.testing.assert_array_equal(a, out_p["params"].numpy())
        np.testing.assert_array_equal(ss["mass"], st_p["mass"].numpy())
        np.testing.assert_array_equal(ss["backlog"]["params"],
                                      st_p["backlog"]["params"].numpy())
        np.testing.assert_allclose(ss["mass"], np.asarray(st_r["mass"]),
                                   rtol=1e-6)
        assert mass_total(ss) == pytest.approx(G, abs=1e-3)


def test_sharded_push_sum_multi_round_stays_exact(world):
    """8 faulty push-sum rounds: the backlogs carry state from round to
    round; every round within 1e-5 of the reference, mass conserved."""
    _, x0, x = packed_setup()
    ex = jcomm.get_exchange("push_sum", "fp32", G, **PUSH8)
    fr = jax.jit(ex.streams)
    sr = ex.init(jnp.asarray(x0))
    xr = jnp.asarray(x)
    for got in world["push8"]:
        o_r, sr = fr({"params": xr}, {}, sr)
        xr = o_r["params"]
        np.testing.assert_allclose(got["mixed"]["params"], np.asarray(xr),
                                   rtol=1e-5, atol=1e-6)
        assert mass_total(got["state"]) == pytest.approx(G, abs=1e-3)
    last = world["push8"][-1]["state"]
    for k in ("mass", "backlog_w"):
        np.testing.assert_allclose(last[k], np.asarray(sr[k]), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(last["backlog"]["params"],
                               np.asarray(sr["backlog"]["params"]),
                               rtol=1e-5, atol=1e-6)
    assert int(last["round"]) == 8


@pytest.mark.parametrize("name", sorted(ROUNDS))
def test_sharded_faulty_rounds_match_replicated(world, name):
    """Whole faulty rounds (the staleness buffers of the faulty server;
    masked hops with per-hop int8 on the ring; adamw on gossip) against
    the reference's replicated round."""
    got, (st_r, ms_r) = world[name], world["refs"][name]
    st = got["state"]
    assert rel_err(st["params"], st_r["params"]) <= 1e-5
    for k, v in st_r["opt"].items():
        if k != "count":
            assert rel_err(st["opt"][k], v) <= 1e-5, k
    for m, m_r in zip(got["metrics"], ms_r):
        assert float(m["participation"]) == pytest.approx(
            float(m_r["participation"]))
        np.testing.assert_allclose(m["loss"], m_r["loss"], rtol=1e-4)
        assert int(m["wire_bytes"]) == int(m_r["wire_bytes"])
    assert int(st["comm"]["round"]) == int(st_r["comm"]["round"])


@pytest.mark.parametrize("name", sorted(HIER))
def test_sharded_hierarchical_matches_reference(world, name):
    """The tiers' masks, leader weights and int8 noise are the host's
    full-shape arrays, the reference's: the sharded two-tier exchange
    gathered within 1e-5 of the reference's replicated ``streams``, the
    participations and the round exact, the mass within 1e-6."""
    codec, kw = HIER[name]
    _, x0, x = packed_setup()
    got = world[f"hier-{name}"][0]
    ex = jcomm.get_exchange("hierarchical", codec, G, n_pods=2, impl="jnp",
                            fault_seed=6, **kw)
    xs0 = ({"params": jnp.asarray(x0)} if ex.lossy_stream("params")
           else {})
    # eager, as the port's tier tests run it: the participations' float32
    # arithmetic unfused, so they compare exactly
    out_r, st_r = ex.streams({"params": jnp.asarray(x)}, xs0,
                             ex.init(jnp.asarray(x0)))
    ss = got["state"]
    assert rel_err(got["mixed"]["params"], out_r["params"]) <= 1e-5
    for k in ("participation", "participation_intra",
              "participation_inter"):
        assert float(ss[k]) == float(st_r[k]), k
    assert int(ss["round"]) == int(st_r["round"]) == 1
    # the port's replicated round on the same host arrays (hier_round):
    # the same ops element for element, bit for bit
    pex = comm.get_exchange("hierarchical", codec, G, n_pods=2,
                            fault_seed=6, noise_hook=C.table_hook(
                                world["noise"]), **kw)
    out_p, st_p = pex.streams(
        {"params": torch.as_tensor(x)},
        {k: torch.as_tensor(x0) for k in xs0},
        pex.init(torch.as_tensor(x0)))
    np.testing.assert_array_equal(got["mixed"]["params"],
                                  out_p["params"].numpy())
    for k in ("participation", "participation_intra",
              "participation_inter", "mass", "backlog_w"):
        if k in st_p:
            np.testing.assert_array_equal(ss[k], st_p[k].numpy())
    if ex.inter_topology == "push_sum":
        np.testing.assert_allclose(ss["mass"], np.asarray(st_r["mass"]),
                                   rtol=0, atol=1e-6)
        assert mass_total(ss) == pytest.approx(G, abs=1e-3)
    else:
        assert int(ss["codec"]["inter:params"]["count"]) \
            == int(st_r["codec"]["inter:params"]["count"]) == 1


def test_sharded_pod_hop_ppermute_bit_equal_allgather(world):
    """The pod-internal hop's ``Mesh.permute`` and the dense allgather
    read the same neighbour blocks: the exchange and its push-sum state
    bit-equal."""
    a = world["hier-ring-push_sum-fp32"][0]
    b = world["hier-allgather"][0]
    np.testing.assert_array_equal(a["mixed"]["params"],
                                  b["mixed"]["params"])
    for k in ("mass", "backlog_w"):
        np.testing.assert_array_equal(a["state"][k], b["state"][k])
    np.testing.assert_array_equal(a["state"]["backlog"]["params"],
                                  b["state"]["backlog"]["params"])


def test_sharded_hierarchical_multi_round_conserves_mass(world):
    """6 faulty two-tier rounds: every round within 1e-5 of the
    reference's, the mass within 1e-3 of G in both packages."""
    _, x0, x = packed_setup()
    ex = jcomm.get_exchange("hierarchical", "fp32", G, **HIER6)
    fr = jax.jit(ex.streams)
    sr = ex.init(jnp.asarray(x0))
    xr = jnp.asarray(x)
    for got in world["hier6"]:
        o_r, sr = fr({"params": xr}, {}, sr)
        xr = o_r["params"]
        assert rel_err(got["mixed"]["params"], xr) <= 1e-5
        assert mass_total(got["state"]) == pytest.approx(G, abs=1e-3)
        assert mass_total(sr) == pytest.approx(G, abs=1e-3)
    assert int(world["hier6"][-1]["state"]["round"]) == 6


@pytest.mark.parametrize("name", sorted(OVERLAP))
def test_sharded_overlap_round_matches_reference(world, name):
    """3 sharded overlapped rounds (the in-flight payload on the block,
    mixed before the local steps, encoded after them) against the
    reference's replicated overlap round on the same padded layout."""
    got, (st_r, ms_r) = world[name], world["refs"][name]
    st = got["state"]
    np.testing.assert_allclose(st["params"], st_r["params"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(st["comm"]["inflight"]["params"],
                               st_r["comm"]["inflight"]["params"],
                               rtol=1e-5, atol=1e-6)
    assert int(st["comm"]["codec"]["params"]["count"]) \
        == int(st_r["comm"]["codec"]["params"]["count"]) == 3
    for m, m_r in zip(got["metrics"], ms_r):
        for k in m_r:
            if k.startswith("wire_bytes"):
                assert int(m[k]) == int(m_r[k]), k
