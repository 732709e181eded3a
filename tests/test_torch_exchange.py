"""The port's exchange (``repro_torch.comm.exchange``) against the
reference's, on the same numpy inputs:

- ``Exchange.streams`` over three rounds of a three-stream payload
  (params and adamw-like ``m``, ``v``) in every in-scope topology x codec
  cell, with moment codecs and downlink codecs, each package threading
  its own comm state; int8/int8z draw the reference's noise through the
  port's noise hook. Tolerance: ``assert_close_up_to_flips`` of
  ``test_torch_codecs``: a few ulp, except where a last-bit difference
  in a mix (the W product's order, the mean's 1/G) moved a later
  rounding by one codec quantum. The W product's last bits differ from
  XLA's on about half the elements, and the second hop encodes a delta
  some 100x smaller than the values it is taken from, so on the ring
  (mix_rounds 2) its bf16 rounding moves on ~1% of the elements per
  round; each step reaches the three rows a ring hop mixes it into
  (measured: 2.5% of the elements after round 1, 5.5% after round 3).
  So up to 10% of the elements may be off, each by at most one quantum.
  Codec counters and staleness round counters are exact.
- the wire accounting, exactly equal, over every topology x codec x
  moment codec x downlink codec x G x mix_rounds x staleness;
- the refusals: the same combinations refused, with the same message;
  overlap refused by the pytree round, as the reference refuses it, while
  push_sum, the hierarchical tiers and faults run a tree stream there and
  match the reference's (the packed round's are in
  ``tests/test_torch_faults.py`` and its siblings; the pytree round's
  whole exchange in ``tests/test_torch_tree_exchange.py``).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as jcodecs
from repro.comm import exchange as jexchange
from repro_torch.comm import exchange
from test_torch_codecs import assert_close_up_to_flips

N = 1001
STREAMS = ("params", "m", "v")
CODECS = ("fp32", "fp16", "bf16", "int8", "int8z", "topk")
MCODECS = ("fp32", "bf16", "int8", "int8z", "fp16")
TOPOLOGIES = ("server", "ring", "gossip", "async_stale", "none")


def _hook(seed):
    ref = jcodecs.int8(seed=seed, impl="jnp")
    return lambda count, shape: np.asarray(ref.noise(count, shape))


def _cells():
    cells = []
    for i, (topo, codec) in enumerate(itertools.product(TOPOLOGIES, CODECS)):
        if topo == "async_stale" and codec == "topk":
            continue
        cells.append((topo, codec, MCODECS[i % len(MCODECS)], ""))
    cells += [("server", c, m, d) for c, m, d in (
        ("fp32", "fp32", "int8"), ("int8", "int8z", "int8"),
        ("topk", "bf16", "bf16"), ("fp32", "int8", "fp16"))]
    cells += [("async_stale", c, m, d) for c, m, d in (
        ("int8", "fp32", "int8"), ("fp32", "int8z", "bf16"))]
    return cells


def _kw(topo):
    return dict(n_groups=8 if topo == "gossip" else 4,
                mix_rounds=2 if topo == "ring" else 1, staleness=1)


def _delta_max(x, x0):
    spread = np.abs(x0 - x0.mean(axis=0)).max()
    return 2.0 * (np.abs(x - x0).max() + spread)


@pytest.mark.parametrize("topo,codec,mcodec,down", _cells())
def test_streams_match_reference(topo, codec, mcodec, down):
    kw = _kw(topo)
    G = kw["n_groups"]
    seed = 11
    port = exchange.get_exchange(topo, codec, moment_codec=mcodec,
                                 downlink_codec=down, seed=seed,
                                 noise_hook=_hook, **kw)
    ref = jexchange.get_exchange(topo, codec, moment_codec=mcodec,
                                 downlink_codec=down, seed=seed, impl="jnp",
                                 **kw)
    assert (port.name, port.stateful, port.p2p, port.lossy_downlink) == (
        ref.name, ref.stateful, ref.p2p, ref.lossy_downlink)
    assert [port.lossy_stream(s) for s in STREAMS] == [
        ref.lossy_stream(s) for s in STREAMS]
    rs = np.random.RandomState(5)
    start = {s: np.repeat(rs.randn(1, N).astype(np.float32), G, axis=0)
             for s in STREAMS}
    start["v"] = np.abs(start["v"])
    pstate = port.init(torch.tensor(start["params"]),
                       {k: torch.tensor(start[k]) for k in ("m", "v")})
    jstate = ref.init(jnp.asarray(start["params"]),
                      {k: jnp.asarray(start[k]) for k in ("m", "v")})
    pcur = {k: torch.tensor(v) for k, v in start.items()}
    jcur = {k: jnp.asarray(v) for k, v in start.items()}
    for rnd in range(3):
        delta = {s: (rs.randn(G, N) * 0.01).astype(np.float32)
                 for s in STREAMS}
        pxs0 = {s: pcur[s].clone() for s in STREAMS if port.lossy_stream(s)}
        jxs0 = {s: jcur[s] for s in STREAMS if ref.lossy_stream(s)}
        pxs = {s: pcur[s] + torch.tensor(delta[s]) for s in STREAMS}
        jxs = {s: jcur[s] + jnp.asarray(delta[s]) for s in STREAMS}
        x_np = {s: np.asarray(jxs[s]) for s in STREAMS}
        pcur, pstate = port.streams(pxs, pxs0, pstate)
        jcur, jstate = ref.streams(jxs, jxs0, jstate)
        assert set(pstate) == set(jstate)
        for s in STREAMS:
            dm = _delta_max(x_np[s], np.asarray(jxs0.get(s, jcur[s])))
            assert_close_up_to_flips(pcur[s].numpy(), jcur[s],
                                     "int8" if "int8" in (codec, mcodec,
                                                          down)
                                     else "bf16", dm, frac=0.1)
        for s, st in pstate.get("codec", {}).items():
            jst = jstate["codec"][s]
            assert set(st) == set(jst)
            if "count" in st:
                assert int(st["count"]) == int(jst["count"])
            if "residual" in st:
                assert_close_up_to_flips(st["residual"].numpy(),
                                         jst["residual"], "int8", 1.0,
                                         frac=0.1)
        if topo == "async_stale":
            assert int(pstate["round"]) == int(jstate["round"]) == rnd + 1
            for s in STREAMS:
                got = (pstate["pushed"] if s == "params"
                       else pstate["pushed_opt"][s])
                want = (jstate["pushed"] if s == "params"
                        else jstate["pushed_opt"][s])
                assert_close_up_to_flips(got.numpy(), want, "int8", 1.0,
                                         frac=0.1)
        for s, st in pstate.get("down", {}).items():
            assert_close_up_to_flips(st["ref"].numpy(),
                                     jstate["down"][s]["ref"], "int8", 1.0,
                                     frac=0.1)
            assert set(st["state"]) == set(jstate["down"][s]["state"])


def test_fp32_server_is_in_place_and_stateless():
    """The default exchange keeps no state and averages into the live
    buffers; a fused stream is mixed into its own buffer too."""
    x = torch.tensor(np.random.RandomState(0).randn(4, 300).astype(
        np.float32))
    ex = exchange.default_exchange(4)
    assert not ex.stateful and ex.init(x) == {}
    mixed, st = ex.streams({"params": x}, {}, {})
    assert mixed["params"] is x and st == {}
    torch.testing.assert_close(x, x.mean(0, keepdim=True).expand_as(x),
                               rtol=0, atol=0)
    ex8 = exchange.get_exchange("ring", "bf16", 4)
    x0 = x.clone()
    y = x0 + 0.01
    mixed, _ = ex8.streams({"params": y}, {"params": x0}, {})
    assert mixed["params"] is y


@pytest.mark.parametrize("topo,codec", [
    ("server", "int8"), ("server", "bf16"), ("server", "topk"),
    ("ring", "int8"), ("gossip", "fp16")])
def test_fused_stream_matches_the_staged_codecs(topo, codec):
    """``fused=False`` routes every stream through the staged codecs (the
    reference's staged path): the fused codec_mix gives the same mix, up
    to the last bits of the staged path's torch.mean / W product and the
    one-quantum steps they can move on the second hop."""
    kw = dict(n_groups=8 if topo == "gossip" else 4,
              mix_rounds=2 if topo == "ring" else 1, seed=3,
              noise_hook=_hook)
    rs = np.random.RandomState(9)
    x0 = np.repeat(rs.randn(1, N).astype(np.float32), kw["n_groups"], 0)
    x = x0 + (rs.randn(*x0.shape) * 0.01).astype(np.float32)
    out = {}
    for fused in (True, False):
        ex = exchange.get_exchange(topo, codec, fused=fused, **kw)
        st = ex.init(torch.tensor(x0))
        mixed, st = ex.streams({"params": torch.tensor(x)},
                               {"params": torch.tensor(x0)}, st)
        out[fused] = (mixed["params"].numpy(), st)
    assert_close_up_to_flips(out[True][0], out[False][0], "int8",
                             _delta_max(x, x0), frac=0.1)
    for k, v in out[True][1].get("codec", {}).get("params", {}).items():
        assert_close_up_to_flips(np.asarray(v),
                                 np.asarray(out[False][1]["codec"]["params"][k]),
                                 "int8", 1.0, frac=0.1)


def _wire(ex, n, sizes):
    return (ex.wire_bytes_by_stream(n, sizes),
            ex.wire_bytes_up(n, moment_sizes=sizes),
            ex.wire_bytes_down(n, moment_sizes=sizes),
            ex.wire_bytes_by_tier(n, sizes),
            ex.wire_bytes_per_round(n, moment_sizes=sizes),
            ex.senders_per_round(), ex.receivers_per_round())


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_wire_accounting_and_refusals_equal_reference(topo):
    """Every codec x moment codec x downlink codec x G x mix_rounds x
    staleness on ``topo``: the same cells refused with the same message,
    and exactly the reference's wire bytes in every other cell."""
    n_ok = 0
    for codec, mc, down, G, mix, stale in itertools.product(
            CODECS, CODECS, ("",) + CODECS, (4, 8), (1, 2), (1, 3)):
        kw = dict(moment_codec=mc, downlink_codec=down, mix_rounds=mix,
                  staleness=stale)
        try:
            want = jexchange.get_exchange(topo, codec, G, **kw)
        except NotImplementedError as e:
            with pytest.raises(NotImplementedError) as got:
                exchange.get_exchange(topo, codec, G, **kw)
            assert str(got.value) == str(e)
            continue
        port = exchange.get_exchange(topo, codec, G, **kw)
        for n, sizes in ((1001, {}), (1001, {"m": 1001, "v": 1001}),
                         (124_662_528, {"mu": 124_662_528})):
            assert _wire(port, n, sizes) == _wire(want, n, sizes), (
                codec, mc, down, G, mix, stale, n)
        n_ok += 1
    assert n_ok > 100


@pytest.mark.parametrize("kw", [
    dict(topology="push_sum"), dict(topology="hierarchical", n_pods=2),
    dict(topology="server", overlap=True),
    dict(topology="ring", drop_rate=0.1),
    dict(topology="server", stall_rate=0.1),
])
def test_unported_exchanges_are_refused(kw):
    """The exchanges the pytree round once refused. Overlap it still
    refuses, as the reference does (it needs the flat buffer). push_sum,
    the tiers and faults it takes: three rounds of a two-leaf tree stream
    (and a moment stream) match the reference's ``streams`` on the same
    tree, the round counter and participation exactly, the values at
    float32 tolerance (fp32 wires)."""
    ex = exchange.get_exchange(n_groups=4, fault_seed=2, **kw)
    if ex.overlap:
        with pytest.raises(NotImplementedError, match="inflight"):
            ex.check_tree()
        return
    ex.check_tree()
    ref = jexchange.get_exchange(n_groups=4, fault_seed=2, **kw)
    rs = np.random.RandomState(3)
    shapes = {"a": (4, 4, 3), "b": (4, 5)}
    start = {s: {k: np.repeat(rs.randn(1, *v[1:]).astype(np.float32), 4, 0)
                 for k, v in shapes.items()} for s in ("params", "m")}
    pst = ex.init({k: torch.tensor(v) for k, v in start["params"].items()},
                  {"m": {k: torch.tensor(v) for k, v in start["m"].items()}})
    jst = ref.init({k: jnp.asarray(v) for k, v in start["params"].items()},
                   {"m": {k: jnp.asarray(v) for k, v in start["m"].items()}})
    for _ in range(3):
        x = {s: {k: v + rs.randn(*v.shape).astype(np.float32)
                 for k, v in start[s].items()} for s in start}
        pm, pst = ex.streams({s: {k: torch.tensor(v) for k, v in t.items()}
                              for s, t in x.items()}, {}, pst)
        jm, jst = ref.streams({s: {k: jnp.asarray(v) for k, v in t.items()}
                               for s, t in x.items()}, {}, jst)
        assert set(pst) == set(jst)
        assert int(pst["round"]) == int(jst["round"])
        assert float(pst["participation"]) == float(jst["participation"])
        for s in x:
            for k in shapes:
                np.testing.assert_allclose(pm[s][k].numpy(),
                                           np.asarray(jm[s][k]), rtol=1e-5,
                                           atol=1e-6)


def test_unknown_names_are_refused():
    with pytest.raises(ValueError, match="valid topologies"):
        exchange.get_exchange("star", "fp32", 4)
    with pytest.raises(ValueError, match="valid codecs"):
        exchange.get_exchange("server", "int4", 4)
