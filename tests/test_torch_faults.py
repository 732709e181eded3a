"""The port's fault injection (``repro_torch.comm.faults``) and the flat
topologies under faults (server, async_stale, ring, gossip) against the
JAX package, on the same numpy inputs.

- Masks: bit-equal. The splitmix32 hash (key chain and per-index draws)
  over a grid of seeds, lanes, rounds, hops, sub-lanes and indices; every
  mask of ``FaultPlan`` over rounds 0-63, hops 0-1, both offsets and G 1,
  4 and 17 (a node index past G included); the tiers of ``get_exchange``'s
  ``TieredFaultPlan`` are equal plans (their seeds' draws are in the hash
  grid); rates whose boundary falls between float32 values.
- ``Exchange.streams`` of the faulty flat topologies over 10 rounds of a
  three-stream payload, each package threading its own comm state; int8
  draws the reference's noise through the port's noise hook. Tolerance as
  in ``tests/test_torch_exchange.py`` (``assert_close_up_to_flips``: a
  few ulp, up to 10% of the elements one codec quantum apart where a
  last-bit difference moved a later rounding); fp32 streams rtol 1e-5 /
  atol 1e-6. Round counters and participation are exact.
- ``defer_undelivered``, the refusals and the wire bytes (integer-equal)
  over a grid of topology x codec x moment codec x downlink x overlap x
  fault flags, and a checkpoint resume mid-fault, bit-exact with the
  uninterrupted run.
"""
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro import optim as joptim
from repro.comm import codecs as jcodecs
from repro.comm import faults as jfaults
from repro.core import localsgd as jlsgd
from repro.optim import packing as jpacking
from repro_torch import bridge, comm, optim
from repro_torch.comm import codecs, faults
from repro_torch.core import localsgd as lsgd
from repro_torch.optim import packing
from test_torch_codecs import assert_close_up_to_flips
from test_torch_pytree_round import quad_loss_j, quad_loss_t, quadratic

GS = (1, 4, 17)
ROUNDS = 64
FP32 = dict(rtol=1e-5, atol=1e-6)
N = 257
STREAMS = ("params", "m", "v")


def hook(seed):
    """The reference's int8 noise of codec seed ``seed``, for the port's
    noise hook."""
    ref = jcodecs.int8(seed=seed, impl="jnp")
    return lambda count, shape: np.asarray(ref.noise(count, shape))


# ---------------------------------------------------------------------------
# the hash and the masks
# ---------------------------------------------------------------------------


class _TracedSeed:
    """A traced uint32 seed that ``seed & 0xFFFFFFFF`` leaves as it is."""

    def __init__(self, value):
        self.value = value

    def __and__(self, mask):
        return self.value


def _ref_hash(seed, lane, rnd, hop, sub):
    """The reference's key chain and its draws over 17 x 17 indices, for
    one (seed, lane, round, hop, sub), with the seed traced (the
    reference's own ``_key``/``_uniform``, called on a stand-in plan)."""
    plan = types.SimpleNamespace(seed=_TracedSeed(seed))
    key = jfaults.FaultPlan._key(plan, lane, rnd, hop, sub)
    return key, jfaults.FaultPlan._uniform(plan, key, (17 * 17,))


_ref_hash_grid = jax.jit(jax.vmap(_ref_hash))


@pytest.mark.parametrize("lane", sorted(faults.HASH_LANES))
def test_hash_bit_equal_reference(lane):
    seeds = np.array([0, 1, 2, 3, 0x7FFFFFFF, 0xFFFFFFFF], np.uint32)
    grid = np.array(list(itertools.product(range(len(seeds)), range(ROUNDS),
                                           (0, 1), (0, 1))))
    n = len(grid)
    lane_id = faults.hash_lane(lane)
    keys, draws = _ref_hash_grid(
        jnp.asarray(seeds[grid[:, 0]]), jnp.full((n,), lane_id, jnp.int32),
        jnp.asarray(grid[:, 1], jnp.int32), jnp.asarray(grid[:, 2], jnp.int32),
        jnp.asarray(grid[:, 3], jnp.int32))
    keys, draws = np.asarray(keys), np.asarray(draws)
    for i, (s, rnd, hop, sub) in enumerate(grid):
        plan = faults.FaultPlan(seed=int(seeds[s]))
        key = plan._key(lane_id, int(rnd), int(hop), int(sub))
        assert key == int(keys[i])
        np.testing.assert_array_equal(plan._uniform(key, (17 * 17,)),
                                      draws[i])


def _mask_set(plan, rnd, n):
    """Every mask of one round at size n: active, push, the matrix at two
    hops, the edge lanes at two hops and both offsets."""
    out = [plan.active_mask(rnd, n), plan.push_mask(rnd, n)]
    out += [plan.matrix_mask(rnd, h, n) for h in (0, 1)]
    out += [plan.edge_mask(rnd, h, o, n) for h in (0, 1) for o in (0, 1)]
    return out


# (seed, drop, stall, dropouts): rates that are no float32 value, a stall
# without drops, a node absent for rounds [3, 9) and one absent throughout
PLANS = [(0, 0.1, 0.05, ((0, 3, 9),)),
         (1, 0.3, 0.0, ()),
         (2, 0.0, 0.2, ((1, 0, ROUNDS),)),
         (0xFFFFFFFF, 1.0 / 3.0, 0.7, ((0, 60, 70), (5, 0, 9)))]


@pytest.mark.parametrize("seed,drop,stall,dropouts", PLANS)
def test_masks_bit_equal_reference(seed, drop, stall, dropouts):
    """Every mask of the plan, rounds 0-63, at G 1, 4 and 17; the
    hierarchical exchange's two tiers are the reference's plans (the seed
    lanes of its fault seed)."""
    kw = dict(drop_rate=drop, stall_rate=stall, dropouts=dropouts)
    jt = jcomm.get_exchange("hierarchical", "fp32", 4, n_pods=2,
                            fault_seed=seed, intra_drop_rate=drop,
                            intra_stall_rate=stall, **kw).fault_plan
    pt = comm.get_exchange("hierarchical", "fp32", 4, n_pods=2,
                           fault_seed=seed, intra_drop_rate=drop,
                           intra_stall_rate=stall, **kw).fault_plan
    for tier in ("intra", "inter"):
        assert dataclasses_equal(getattr(jt, tier), getattr(pt, tier))
    assert (pt.expected_delivery_intra, pt.expected_delivery_inter) == (
        jt.expected_delivery_intra, jt.expected_delivery_inter)
    jplan = jfaults.FaultPlan(seed=seed, **kw)
    pplan = faults.FaultPlan(seed=seed, **kw)
    got = jax.jit(jax.vmap(lambda r: [
        _mask_set(jplan, r, n) for n in GS]))(jnp.arange(ROUNDS))
    for i, n in enumerate(GS):
        ref = [np.asarray(m) for m in got[i]]
        for rnd in range(ROUNDS):
            for j, m in enumerate(_mask_set(pplan, rnd, n)):
                assert m.dtype == np.float32
                np.testing.assert_array_equal(m, ref[j][rnd])


def dataclasses_equal(a, b):
    return (a.seed, a.drop_rate, a.stall_rate, tuple(a.dropouts)) == (
        b.seed, b.drop_rate, b.stall_rate, tuple(b.dropouts))


def test_rate_boundary_rounds_as_float32():
    """A rate whose float32 value equals a drawn uniform: the reference
    compares ``u >= rate`` in float32, so that draw is delivered; a
    comparison in float64 would drop it."""
    base = faults.FaultPlan(seed=5, drop_rate=0.5)
    key = base._key(faults.hash_lane("fault/edge"), 7, 1, 0)
    u = base._uniform(key, (64,))
    checked = 0
    for x in u[(u > 0.01) & (u < 0.99)][:12]:
        rate = float(np.nextafter(np.float64(x), 1.0))   # just above u
        assert np.float32(rate) == x and rate > float(x)
        jm = np.asarray(jfaults.FaultPlan(seed=5, drop_rate=rate)
                        .edge_mask(7, 1, 0, 64))
        pm = faults.FaultPlan(seed=5, drop_rate=rate).edge_mask(7, 1, 0,
                                                                   64)
        np.testing.assert_array_equal(pm, jm)
        assert pm[list(u).index(x)] == 1.0
        checked += 1
    assert checked >= 10


def test_registry_lanes_unique_and_stable():
    for reg in (faults.HASH_LANES, faults.CODEC_SEED_OFFSETS,
                faults.FAULT_SEED_OFFSETS):
        assert len(set(reg.values())) == len(reg)
    assert faults.HASH_LANES == jfaults.HASH_LANES
    assert faults.CODEC_SEED_OFFSETS == jfaults.CODEC_SEED_OFFSETS
    assert faults.FAULT_SEED_OFFSETS == jfaults.FAULT_SEED_OFFSETS
    for seed in (0, 7, 0xFFFFFFFF):
        for tier in faults.FAULT_SEED_OFFSETS:
            assert (faults.fault_seed_for(seed, tier)
                    == jfaults.fault_seed_for(seed, tier))
    for fn, bad in ((faults.hash_lane, "fault/none"),
                    (lambda n: faults.fault_seed_for(0, n), "dcn"),
                    (lambda n: faults.codec_seed(0, n), "grads")):
        with pytest.raises(ValueError, match="valid"):
            fn(bad)


def test_plan_validation_and_delivery():
    for bad in (dict(drop_rate=1.0), dict(drop_rate=-0.1),
                dict(stall_rate=1.5), dict(stall_rate=-1e-9)):
        with pytest.raises(ValueError, match=r"not in \[0, 1\)"):
            faults.FaultPlan(**bad)
    assert faults.FaultPlan().trivial
    assert not faults.FaultPlan(dropouts=((2, 1, 3),)).trivial
    for kw in (dict(drop_rate=0.25), dict(drop_rate=0.2, stall_rate=0.1)):
        assert (faults.FaultPlan(**kw).expected_delivery
                == jfaults.FaultPlan(**kw).expected_delivery)
    tp = faults.TieredFaultPlan(intra=faults.FaultPlan(),
                                inter=faults.FaultPlan(drop_rate=0.1))
    assert tp.intra is None and not tp.trivial
    assert tp.expected_delivery == pytest.approx(0.9)
    assert faults.TieredFaultPlan(faults.FaultPlan(),
                                  faults.FaultPlan()).trivial


# ---------------------------------------------------------------------------
# the exchange's streams under faults, against the reference
# ---------------------------------------------------------------------------


def run_streams_pair(port, ref, n_groups, rounds, seed=5, scale=0.1,
                     streams=STREAMS, check=None):
    """Both exchanges over ``rounds`` rounds of a multi-stream payload from
    one numpy draw (a common start, a fresh delta per group each round),
    each package threading its own state. After each round: the same
    state keys, round counter and participation scalars, and the mixed
    streams, to the tolerances of the module docstring. ``check(pstate,
    jstate)`` runs after each round."""
    lossy = any(port.stream_codec(s).name in ("int8", "int8z", "topk")
                for s in streams)
    cast = any(port.stream_codec(s).name in ("fp16", "bf16")
               for s in streams) or (port.inter_codec is not None
                                     and port.inter_codec.name != "fp32")
    rs = np.random.RandomState(seed)
    start = {s: np.repeat(rs.randn(1, N).astype(np.float32), n_groups, 0)
             for s in streams}
    if "v" in start:
        start["v"] = np.abs(start["v"])
    moments = [s for s in streams if s != "params"]
    pstate = port.init(torch.tensor(start["params"]),
                       {k: torch.tensor(start[k]) for k in moments} or None)
    jstate = ref.init(jnp.asarray(start["params"]),
                      {k: jnp.asarray(start[k]) for k in moments} or None)
    pcur = {k: torch.tensor(v) for k, v in start.items()}
    jcur = {k: jnp.asarray(v) for k, v in start.items()}
    for _ in range(rounds):
        delta = {s: (rs.randn(n_groups, N) * scale).astype(np.float32)
                 for s in streams}
        pxs0 = {s: pcur[s].clone() for s in streams if port.lossy_stream(s)}
        jxs0 = {s: jcur[s] for s in streams if ref.lossy_stream(s)}
        pxs = {s: pcur[s] + torch.tensor(delta[s]) for s in streams}
        jxs = {s: jcur[s] + jnp.asarray(delta[s]) for s in streams}
        spread = {s: np.abs(np.asarray(jxs[s])).max() for s in streams}
        pcur, pstate = port.streams(pxs, pxs0, pstate)
        jcur, jstate = ref.streams(jxs, jxs0, jstate)
        assert set(pstate) == set(jstate)
        for k in ("round",):
            assert int(pstate[k]) == int(jstate[k])
        for k in ("participation", "participation_intra",
                  "participation_inter"):
            if k in jstate:
                assert float(pstate[k]) == float(jstate[k]), k
        for s in streams:
            got, want = pcur[s].numpy(), np.asarray(jcur[s])
            if lossy:
                assert_close_up_to_flips(got, want, "int8", 2 * spread[s],
                                         frac=0.1)
            elif cast:
                assert_close_up_to_flips(got, want, "bf16", 2 * spread[s],
                                         frac=0.1)
            else:
                np.testing.assert_allclose(got, want, **FP32)
        if check is not None:
            check(pstate, jstate)
    return pstate, jstate


FLAT_CELLS = [
    ("server", "fp32", dict(moment_codec="bf16", drop_rate=0.3,
                            stall_rate=0.1)),
    ("server", "int8", dict(moment_codec="int8z", drop_rate=0.3)),
    ("server", "topk", dict(topk_frac=0.1, drop_rate=0.3,
                            dropouts=((2, 0, 2),))),
    ("async_stale", "int8", dict(staleness=1, drop_rate=0.25)),
    ("async_stale", "fp32", dict(staleness=2, stall_rate=0.2,
                                 moment_codec="fp16")),
    ("ring", "int8", dict(mix_rounds=2, drop_rate=0.2, stall_rate=0.1)),
    ("ring", "fp32", dict(mix_rounds=1, drop_rate=0.1)),
    ("gossip", "fp32", dict(n_groups=8, mix_rounds=2, drop_rate=0.2,
                            stall_rate=0.1, moment_codec="bf16")),
]


@pytest.mark.parametrize("topo,codec,kw", FLAT_CELLS)
def test_faulty_streams_match_reference(topo, codec, kw):
    kw = dict(kw)
    G = kw.pop("n_groups", 4)
    port = comm.get_exchange(topo, codec, G, seed=11, fault_seed=3,
                             noise_hook=hook, **kw)
    ref = jcomm.get_exchange(topo, codec, G, seed=11, fault_seed=3,
                             impl="jnp", **kw)
    assert (port.name, port.stateful, port.faulty, port.delivery_rate) == (
        ref.name, ref.stateful, ref.faulty, ref.delivery_rate)
    streams = ("params",) if codec == "topk" else STREAMS

    def check(ps, js):
        for s, st in ps.get("codec", {}).items():
            if "count" in st:
                assert int(st["count"]) == int(js["codec"][s]["count"])
            if "residual" in st:
                assert_close_up_to_flips(st["residual"].numpy(),
                                         js["codec"][s]["residual"], "int8",
                                         1.0, frac=0.1)
        if "pushed" in js:
            np.testing.assert_allclose(ps["pushed"].numpy(),
                                       np.asarray(js["pushed"]), rtol=1e-5,
                                       atol=2e-2 if codec != "fp32" else 1e-6)

    run_streams_pair(port, ref, G, 10, streams=streams, check=check)


def test_faulty_server_participation_and_retry():
    """Participation is the delivered fraction of the push mask; the
    broadcast is the mean of fresh pushes where delivered and each
    dropped group's last delivered push."""
    ex = comm.get_exchange("server", "fp32", 4, drop_rate=0.4, fault_seed=3)
    rs = np.random.RandomState(0)
    x0 = torch.tensor(rs.randn(4, 32).astype(np.float32))
    st = ex.init(x0)
    pushed = x0.clone()
    parts = []
    for rnd in range(6):
        xs = x0 + torch.tensor(rs.randn(4, 32).astype(np.float32))
        delivered = ex.fault_plan.push_mask(rnd, 4)
        pushed = torch.where(torch.tensor(delivered > 0)[:, None], xs, pushed)
        out, st = ex.params(xs.clone(), None, st)
        torch.testing.assert_close(out, pushed.mean(0, keepdim=True)
                                   .expand_as(out), rtol=0, atol=0)
        parts.append(float(st["participation"]))
        assert parts[-1] == pytest.approx(delivered.mean())
    assert min(parts) < 1.0


def test_defer_undelivered_matches_reference():
    rs = np.random.RandomState(1)
    res, d = (rs.randn(4, 50).astype(np.float32) for _ in range(2))
    delivered = np.array([1, 0, 1, 0], np.float32)
    got = codecs.defer_undelivered({"residual": torch.tensor(res)},
                                   torch.tensor(d), torch.tensor(delivered))
    want = jcodecs.defer_undelivered({"residual": jnp.asarray(res)},
                                     jnp.asarray(d), jnp.asarray(delivered))
    np.testing.assert_array_equal(got["residual"].numpy(),
                                  np.asarray(want["residual"]))
    st = {"count": torch.zeros((), dtype=torch.int32)}
    assert codecs.defer_undelivered(st, torch.tensor(d),
                                    torch.tensor(delivered)) is st


def test_ef_residual_defers_on_undelivered_push():
    """Group 2 absent for round 0: its shipped top-k entries go back into
    its residual (residual == c exactly); delivered groups keep c ==
    d_hat + residual, with at most k entries shipped."""
    rs = np.random.RandomState(2)
    x0 = torch.tensor(rs.randn(4, 200).astype(np.float32))
    x = x0 + torch.tensor(rs.randn(4, 200).astype(np.float32))
    c = (x - x0).numpy()
    ex = comm.get_exchange("server", "topk", 4, topk_frac=0.1,
                           dropouts=((2, 0, 1),))
    st = ex.init(x0)
    out, st = ex.params(x.clone(), x0, st)
    res = st["codec"]["params"]["residual"].numpy()
    np.testing.assert_allclose(res[2], c[2], atol=1e-6)
    for g in (0, 1, 3):
        assert 1 <= int((np.abs(c[g] - res[g]) > 1e-12).sum()) <= 20
    out2, st2 = ex.params(out.clone(), out, st)
    assert (np.abs(st2["codec"]["params"]["residual"].numpy()[2]).sum()
            < np.abs(res[2]).sum())


def test_faulty_mixing_rows_stay_stochastic():
    """A faulty gossip hop's output is a convex combination of its input:
    the bounds never widen."""
    x = torch.tensor(np.random.RandomState(3).randn(4, 16).astype(
        np.float32) * 5)
    ex = comm.get_exchange("gossip", "fp32", 4, mix_rounds=3, drop_rate=0.3,
                           stall_rate=0.2, fault_seed=5)
    st = ex.init(x)
    hi, lo = float(x.max()), float(x.min())
    for _ in range(10):
        x, st = ex.params(x, None, st)
        assert float(x.max()) <= hi + 1e-5 and float(x.min()) >= lo - 1e-5


def test_zero_rates_attach_no_plan():
    for topo in ("server", "ring", "gossip", "async_stale", "push_sum",
                 "none"):
        ex = comm.get_exchange(topo, "fp32", 4, mix_rounds=2, drop_rate=0.0,
                               stall_rate=0.0, fault_seed=9)
        assert ex.fault_plan is None and not ex.faulty
        assert ex.name == comm.get_exchange(topo, "fp32", 4,
                                            mix_rounds=2).name


# ---------------------------------------------------------------------------
# refusals and wire bytes
# ---------------------------------------------------------------------------


def _wire(ex, n, sizes):
    return (ex.wire_bytes_by_stream(n, sizes),
            ex.wire_bytes_up(n, moment_sizes=sizes),
            ex.wire_bytes_down(n, moment_sizes=sizes),
            ex.wire_bytes_by_tier(n, sizes),
            ex.wire_bytes_per_round(n, moment_sizes=sizes),
            ex.senders_per_round(), ex.receivers_per_round(),
            ex.delivery_rate, ex.delivery_rate_intra, ex.delivery_rate_inter,
            ex.stateful, ex.name, ex.p2p, ex.lossy_downlink)


FAULT_FLAGS = ({}, dict(drop_rate=0.1, fault_seed=2), dict(stall_rate=0.2),
               dict(dropouts=((1, 0, 2),)))


def assert_same_refusals_and_wire(topo, grid, n_groups=4, extra=None):
    """Every cell of ``grid`` (kwargs of get_exchange): the same exception
    type and message, or exactly the reference's wire bytes. Returns the
    count of cells both packages accept."""
    n_ok = 0
    for kw in grid:
        kw = {**kw, **(extra or {})}
        try:
            want = jcomm.get_exchange(topo, n_groups=n_groups, **kw)
        except (NotImplementedError, ValueError) as e:
            with pytest.raises(type(e)) as got:
                comm.get_exchange(topo, n_groups=n_groups, **kw)
            assert str(got.value) == str(e), kw
            continue
        port = comm.get_exchange(topo, n_groups=n_groups, **kw)
        for n, sizes in ((1001, {}), (1001, {"m": 1001, "v": 1001}),
                         (124_662_528, {"mu": 124_662_528})):
            assert _wire(port, n, sizes) == _wire(want, n, sizes), kw
        n_ok += 1
    return n_ok


@pytest.mark.parametrize("topo", ["server", "ring", "gossip", "async_stale",
                                  "push_sum", "none"])
def test_refusals_and_wire_equal_reference(topo):
    """topology x codec x moment codec x downlink x overlap x fault flags
    (and mix_rounds 1, 2)."""
    grid = [dict(codec=c, moment_codec=m, downlink_codec=d, overlap=o,
                 mix_rounds=k, **f)
            for c, m, d, o, k, f in itertools.product(
                ("fp32", "bf16", "int8", "topk"),
                ("fp32", "fp16", "int8z", "topk"), ("", "int8"),
                (False, True), (1, 2), FAULT_FLAGS)]
    assert assert_same_refusals_and_wire(topo, grid) > 10


# ---------------------------------------------------------------------------
# the packed round under faults
# ---------------------------------------------------------------------------


def packed_runs(topo, codec, opt_name, lr, rounds, ex_kw, g=4, seed=0,
                ref=True):
    """The packed round on the quadratic of ``test_torch_pytree_round``
    in both packages: ``(jax states, jax metrics, port states, port
    metrics, port round, port exchange)``, one state per round (the
    reference's jitted; the port's buffers are copied out)."""
    params, batch = quadratic(seed, g=g)
    cfg = dict(n_groups=g, inner_steps=2)
    ex = comm.get_exchange(topo, codec, g, noise_hook=hook, **ex_kw)
    tp = bridge.params_from_numpy(params)
    layout = packing.layout_of(tp)
    opt = optim.packed(opt_name, lr)
    rnd = lsgd.make_local_round(quad_loss_t, opt, lsgd.LocalSGDConfig(**cfg),
                                layout=layout, exchange=ex)
    st = lsgd.init_state(tp, opt, g, layout, exchange=ex)
    tb = bridge.params_from_numpy(batch)
    tstates, tms = [], []
    for _ in range(rounds):
        st, m = rnd(st, tb)
        tstates.append(_copy(st))
        tms.append(m)
    if not ref:
        return None, None, tstates, tms, rnd, ex
    jparams = jax.tree.map(jnp.asarray, params)
    jlayout = jpacking.layout_of(jparams)
    jopt = joptim.packed(opt_name, lr, impl="jnp")
    jex = jcomm.get_exchange(topo, codec, g, impl="jnp", **ex_kw)
    jrnd = jax.jit(jlsgd.make_local_round(quad_loss_j, jopt,
                                          jlsgd.LocalSGDConfig(**cfg),
                                          layout=jlayout, exchange=jex))
    jst = jlsgd.init_state(jparams, jopt, n_groups=g, layout=jlayout,
                           exchange=jex)
    jb = jax.tree.map(jnp.asarray, batch)
    jstates, jms = [], []
    for _ in range(rounds):
        jst, jm = jrnd(jst, jb)
        jstates.append(jax.device_get(jst))
        jms.append(jax.device_get(jm))
    return jstates, jms, tstates, tms, rnd, ex


def _copy(tree_):
    if isinstance(tree_, dict):
        return {k: _copy(v) for k, v in tree_.items()}
    return tree_.clone()


def _leaves(tree_, prefix=()):
    if isinstance(tree_, dict):
        for k in sorted(tree_):
            yield from _leaves(tree_[k], prefix + (k,))
    else:
        yield prefix, tree_


def assert_round_metrics(jm, tm, exact=("participation",
                                        "participation_intra",
                                        "participation_inter",
                                        "delivery_rate",
                                        "delivery_rate_intra",
                                        "delivery_rate_inter"), tol=FP32):
    assert set(tm) == set(jm)
    for k, jv in jm.items():
        if k.startswith("wire_bytes") or k == "inner_steps" or k in exact:
            np.testing.assert_array_equal(np.asarray(tm[k]), np.asarray(jv),
                                          err_msg=k)
        else:
            np.testing.assert_allclose(np.asarray(tm[k]), np.asarray(jv),
                                       err_msg=k, **tol)


@pytest.mark.parametrize("topo,codec,opt_name,kw", [
    ("server", "fp32", "adamw", dict(drop_rate=0.3, fault_seed=1)),
    ("gossip", "fp32", "momentum", dict(drop_rate=0.2, stall_rate=0.1,
                                        fault_seed=2)),
])
def test_faulty_packed_round_matches_reference(topo, codec, opt_name, kw):
    """The round's params, moments, comm state and every metric against
    the reference's jitted round over 4 rounds (participation exact)."""
    lr = {"adamw": 0.02, "momentum": 0.1}[opt_name]
    js, jms, ts, tms, _, _ = packed_runs(topo, codec, opt_name, lr, 4, kw)
    for jst, tst, jm, tm in zip(js, ts, jms, tms):
        np.testing.assert_allclose(tst["params"].numpy(), jst["params"],
                                   **FP32)
        for k in tst["opt"]:
            np.testing.assert_allclose(tst["opt"][k].numpy(),
                                       np.asarray(jst["opt"][k]), **FP32)
        assert int(tst["comm"]["round"]) == int(jst["comm"]["round"])
        assert_round_metrics(jm, tm)


@pytest.mark.parametrize("topo,codec,kw", [
    ("async_stale", "int8", dict(staleness=1, drop_rate=0.2)),
    ("push_sum", "fp32", dict(drop_rate=0.1, stall_rate=0.05)),
    ("server", "topk", dict(drop_rate=0.25)),
])
def test_checkpoint_resume_mid_fault_bit_exact(topo, codec, kw, tmp_path):
    """Save at round 3 under an active plan (staleness buffers, an EF
    residual or mass counters in flight), load with ``checkpoint/io``,
    and 3 more rounds equal the uninterrupted run's bit for bit: the
    round counter rides the comm state and the masks are pure in (round,
    seed)."""
    from repro_torch.checkpoint import io as ckpt_io

    _, _, ts, _, rnd, ex = packed_runs(topo, codec, "momentum", 0.05, 3,
                                       dict(fault_seed=4, **kw), ref=False)
    st = ts[-1]
    assert int(st["comm"]["round"]) == 3
    path = str(tmp_path / "mid_fault")
    ckpt_io.save(path, st, metadata={"round": 3, "comm": ex.name})
    back = ckpt_io.load(path, st)
    params, batch = quadratic(0)
    tb = bridge.params_from_numpy(batch)
    for _ in range(3):
        st, m1 = rnd(st, tb)
        back, m2 = rnd(back, tb)
    for (pa, a), (pb, b) in zip(_leaves(st), _leaves(back)):
        assert pa == pb
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k in m1:
        torch.testing.assert_close(torch.as_tensor(m1[k]),
                                   torch.as_tensor(m2[k]), rtol=0, atol=0)
