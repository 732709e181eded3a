"""The port's lossy-exchange pieces against the JAX package, on the same
numpy inputs: the plain versions of the ``qdq_int8`` and ``codec_mix``
kernels (what their wrappers run on a CPU tensor) against the
reference's ``impl="jnp"`` path and its Pallas kernels in interpret mode;
the codecs with the reference's own noise fed through the noise hook;
``chunk_rows``; the topologies and the codec seed lanes.

Tolerances, with their reasons:
- ``qdq_int8``, the int8/int8z codecs, the casts, top-k and the G-mean at
  a power-of-two G are bit-equal to the reference's eager jnp path: each
  element is the same chain of IEEE operations. The reference's Pallas
  kernel runs under XLA's jit, which turns ``amax / 127`` into a product
  with 1/127, so its scales differ from a true quotient in the last bit:
  the port is held to it at a few ulp, with the rare floor that moves
  by one step allowed one quantum (as for hops=2 below).
- At other G the reference divides the G-sum by multiplying with 1/G,
  and its W contraction is a matrix product in XLA's order; the port
  divides and sums over k in sequence. So those outputs agree to a few
  ulp: rtol 1e-6, atol 1e-7.
- From the second hop on (``hops=2``), a last-bit difference in one
  hop's mix can move the next hop's rounding (int8's floor, or the
  bf16/fp16 cast) by one step on a few elements: those may differ by one
  quantum of the codec (bounded here by the delta's size over 127, 2^7
  or 2^10), on at most 2% of the elements.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as jcodecs
from repro.comm import faults as jfaults
from repro.comm import topology as jtopo
from repro.kernels import exchange_epilogue as jee
from repro.optim import packing as jpacking
from repro_torch.comm import codecs, faults, topology
from repro_torch.kernels import exchange_epilogue as ee
from repro_torch.optim import packing

ULP = dict(rtol=1e-6, atol=1e-7)
QUANTUM_DIV = {"int8": 127.0, "bf16": 2.0 ** 7, "fp16": 2.0 ** 10}


def _rand(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _t(a):
    return None if a is None else torch.tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def assert_close_up_to_flips(got, want, kind, delta_max, frac=0.02):
    """Within a few ulp everywhere, except at most ``frac`` of the
    elements, which may differ by one codec quantum (see the module
    docstring)."""
    got, want = np.asarray(got), np.asarray(want)
    off = ~np.isclose(got, want, **ULP)
    assert off.mean() <= frac, f"{off.sum()} of {off.size} elements off"
    quantum = 2.0 * delta_max / QUANTUM_DIV[kind]
    np.testing.assert_array_less(np.abs(got - want)[off], quantum)


def test_qdq_int8_matches_reference():
    """Ragged row counts, all-zero rows and all-zero halves."""
    rows = _rand(0, (67, 256), 0.01)
    rows[3] = 0.0
    rows[7, :100] = 0.0
    rows[11, 5] = 40.0                      # one large outlier in its row
    u = np.random.RandomState(1).rand(67, 256).astype(np.float32)
    got = ee.qdq_int8(_t(rows), _t(u)).numpy()
    jnp_ = jcodecs.int8(impl="jnp").compress_rows(_j(rows), _j(u))
    pallas = jee.qdq_int8(_j(rows), _j(u), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(jnp_))
    assert_close_up_to_flips(got, pallas, "int8", np.abs(rows).max())
    np.testing.assert_array_equal(got[3], 0.0)


def test_int8z_core_matches_reference():
    """int8z pins the noise to 0.5 below half a quantum, then runs the
    same core: bit-equal, and sub-half-quantum entries decode to 0."""
    rows = _rand(2, (33, 256), 0.01)
    rows[:, :64] *= 1e-4
    u = np.random.RandomState(3).rand(33, 256).astype(np.float32)
    got = codecs.int8z().compress_rows(_t(rows), _t(u)).numpy()
    want = jcodecs.int8z(impl="jnp").compress_rows(_j(rows), _j(u))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got[:, :64] == 0.0).all()


def _mix_case(kind, G, N, w, hops, seed=0):
    x0 = _rand(seed, (G, N))
    x = x0 + _rand(seed + 1, (G, N), 0.01)
    u = res = tau = None
    nh = hops if w is not None else 1
    if kind == "int8":
        u = np.random.RandomState(seed + 2).rand(
            nh, G * -(-N // 256), 256).astype(np.float32)
    if kind == "thresh":
        res = _rand(seed + 3, (G, N), 0.005)
        c = np.abs((x - x0) + res)
        tau = np.sort(c, axis=1)[:, -(N // 10)][:, None].astype(np.float32)
    return x, x0, u, res, tau


MIX_CASES = ([(k, "mean", 4, 1000, 1) for k in ee.KINDS]
             + [(k, "mean", 3, 513, 1) for k in ee.KINDS]
             + [(k, t, g, n, h) for t, g, n in (("ring", 4, 1000),
                                                ("gossip", 8, 777))
                for k in ("int8", "bf16", "fp16") for h in (1, 2)])


@pytest.mark.parametrize("kind,topo,G,N,hops", MIX_CASES)
def test_codec_mix_matches_reference(kind, topo, G, N, hops):
    """Every kind on the mean (G = 4 and 3), on the ring (G = 4) and on
    gossip_matrix(8, seed=0) (unequal weights, zero entries) at hops 1
    and 2, with a ragged N (the int8 pad)."""
    w = None if topo == "mean" else jtopo.mixing_matrix(topo, G, seed=0)
    x, x0, u, res, tau = _mix_case(kind, G, N, w, hops)
    kw = dict(kind=kind, w=w, hops=hops, chunk=256 if kind == "int8" else 0)
    before = dict(ee.launches)
    got, got_res = ee.codec_mix(_t(x), _t(x0), u=_t(u), residual=_t(res),
                                tau=_t(tau), **kw)
    assert ee.launches == before            # the plain version ran
    want, want_res = jee.codec_mix(_j(x), _j(x0), u=_j(u), residual=_j(res),
                                   tau=_j(tau), impl="jnp", **kw)
    kern, _ = jee.codec_mix(_j(x), _j(x0), u=_j(u), residual=_j(res),
                            tau=_j(tau), impl="pallas", interpret=True, **kw)
    got = got.numpy()
    if topo == "mean" and G in (1, 2, 4, 8):
        np.testing.assert_array_equal(got, np.asarray(want))
    elif hops == 1:
        np.testing.assert_allclose(got, np.asarray(want), **ULP)
    else:
        assert_close_up_to_flips(got, want, kind,
                                 np.abs(x).max() + np.abs(x0).max())
    if hops == 1:
        np.testing.assert_allclose(got, np.asarray(kern), **ULP)
    else:
        assert_close_up_to_flips(got, kern, kind,
                                 np.abs(x).max() + np.abs(x0).max())
    if kind == "thresh":
        np.testing.assert_array_equal(got_res.numpy(), np.asarray(want_res))


def test_codec_mix_writes_in_place():
    """``out=x`` and ``residual_out=residual`` (what the exchange passes)
    give the same values as fresh outputs."""
    x, x0, u, res, tau = _mix_case("thresh", 4, 1000, None, 1)
    want, want_res = ee.codec_mix(_t(x), _t(x0), kind="thresh",
                                  residual=_t(res), tau=_t(tau))
    tx, tres = _t(x), _t(res)
    got, got_res = ee.codec_mix(tx, _t(x0), kind="thresh", residual=tres,
                                tau=_t(tau), out=tx, residual_out=tres)
    assert got is tx and got_res is tres
    assert torch.equal(tx, want) and torch.equal(tres, want_res)


def test_epilogue_dispatch_rules():
    x = torch.zeros(2, 512)
    u = torch.zeros(1, 4, 256)
    with pytest.raises(ValueError, match="impl='cuda'"):
        ee.codec_mix(x, x, kind="int8", u=u, chunk=256, impl="cuda")
    with pytest.raises(ValueError, match="impl='cuda'"):
        ee.qdq_int8(torch.zeros(4, 256), torch.zeros(4, 256), impl="cuda")
    with pytest.raises(ValueError, match="unknown kind"):
        ee.codec_mix(x, x, kind="int4")
    with pytest.raises(ValueError, match="shape"):
        ee.codec_mix(x, x, kind="int8", u=torch.zeros(1, 3, 256), chunk=256)
    with pytest.raises(ValueError, match="thresh"):
        ee.codec_mix(x, x, kind="thresh", w=np.eye(2), residual=x,
                     tau=torch.zeros(2, 1))
    with pytest.raises(TypeError, match="float32"):
        ee.qdq_int8(torch.zeros(4, 256).double(), torch.zeros(4, 256))


@pytest.mark.parametrize("shape,chunk", [((3, 1000), 256), ((1001,), 256),
                                         ((2, 512), 256), ((4, 7), 4)])
def test_chunk_rows_matches_reference(shape, chunk):
    x = _rand(4, shape)
    rows = packing.chunk_rows(_t(x), chunk)
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(jpacking.chunk_rows(_j(x), chunk)))
    np.testing.assert_array_equal(
        packing.pad_rows(_t(x), chunk).numpy(),
        np.asarray(jpacking.pad_rows(_j(x), chunk)))
    np.testing.assert_array_equal(packing.unchunk_rows(rows, shape).numpy(),
                                  x)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8, 9, 16])
def test_topologies_equal_reference(m):
    for name in ("server", "ring", "gossip"):
        for seed in (0, 3):
            w = topology.mixing_matrix(name, m, seed=seed)
            np.testing.assert_array_equal(
                w, jtopo.mixing_matrix(name, m, seed=seed))
            assert topology.is_doubly_stochastic(w)
            assert topology.n_edge_sends(w) == jtopo.n_edge_sends(w)
            assert topology.spectral_gap(w) == jtopo.spectral_gap(w)
    with pytest.raises(ValueError, match="valid mixing-matrix"):
        topology.mixing_matrix("push_sum", m)


def test_codec_seed_lanes_equal_reference():
    assert faults.CODEC_SEED_OFFSETS == jfaults.CODEC_SEED_OFFSETS
    for base in (0, 7, 2 ** 32 - 1):
        for lane in faults.CODEC_SEED_OFFSETS:
            assert faults.codec_seed(base, lane) == jfaults.codec_seed(
                base, lane)
    with pytest.raises(ValueError, match="unknown codec seed lane"):
        faults.codec_seed(0, "fault/edge")


def _ref_noise(seed):
    ref = jcodecs.int8(seed=seed, impl="jnp")
    return lambda count, shape: np.asarray(ref.noise(count, shape))


@pytest.mark.parametrize("name", codecs.CODECS)
def test_codecs_compress_match_reference(name):
    """Two compress applications of every codec on a ragged (G, N) delta,
    threading the codec state; int8/int8z draw the reference's noise
    through the hook. Wire bytes are exact."""
    port = codecs.get_codec(name, seed=5, noise_fn=_ref_noise(5))
    ref = jcodecs.get_codec(name, seed=5, impl="jnp")
    assert (port.identity, port.stateful, port.chunk, port.topk_frac) == (
        ref.identity, ref.stateful, ref.chunk, ref.topk_frac)
    for n in (1, 255, 256, 1001, 124_662_528):
        assert port.wire_bytes(n) == ref.wire_bytes(n)
    delta = _rand(6, (3, 1001), 0.01)
    ps, rs = port.init(_t(delta)), ref.init(_j(delta))
    for step in range(2):
        d = delta * (step + 1)
        got, ps = port.compress(_t(d), ps)
        want, rs = ref.compress(_j(d), rs)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert set(ps) == set(rs)
        for k in ps:
            np.testing.assert_array_equal(np.asarray(ps[k]),
                                          np.asarray(rs[k]))


def test_default_noise_is_deterministic_per_seed_and_count():
    c = codecs.int8(seed=3)
    a = c.noise(torch.tensor(4), (8, 256), torch.device("cpu"))
    assert torch.equal(a, c.noise(4, (8, 256), torch.device("cpu")))
    assert not torch.equal(a, c.noise(5, (8, 256), torch.device("cpu")))
    assert not torch.equal(a, codecs.int8(seed=4).noise(
        4, (8, 256), torch.device("cpu")))
    assert a.dtype == torch.float32 and 0.0 <= a.min() and a.max() < 1.0
    with pytest.raises(ValueError, match="valid codecs"):
        codecs.get_codec("int4")
