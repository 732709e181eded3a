"""The geometries the port's kernels take on the card, and the port against
the reference at the geometries that used to be refused there.

- the exchange's routing: a stream of more than 16 groups, or an int8
  chunk other than 256, takes the fused epilogue like any other, as in
  the reference (``codec_mix`` takes any G and chunk, on the card through
  its general kernel).
- ``codec_mix``'s plain version (what the CPU runs, and what the card's
  kernels are held to bit for bit) against the reference's at G 17 and
  32 and int8 chunks 37, 128 and 512, at ``test_torch_codecs``'
  tolerances.
- the exchange at G 32 (int8 server and ring, top-k) and at int8 chunk
  128, fused and staged, against the reference's on the same numpy inputs
  and noise, at ``test_torch_exchange``'s tolerance.
- every attention config of the reference whose heads reach the kernels
  is admitted by ``flash_attention.takes`` and ``decode_attention.takes``.
- flash and decode (their plain versions, which the CPU runs) against the
  reference at hd 112 and g 3, 6 and 16, at their tests' tolerances; the
  zero padding of the head dim against the unpadded plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import exchange as jexchange
from repro.comm import topology as jtopo
from repro.configs.base import all_configs
from repro.kernels import decode_attention as jda
from repro.kernels import exchange_epilogue as jee
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.comm import codecs, exchange
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import exchange_epilogue as ee
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from test_torch_codecs import ULP, assert_close_up_to_flips
from test_torch_decode_attention import TOL as DECODE_TOL
from test_torch_decode_attention import _case as decode_case
from test_torch_decode_attention import _port as decode_port
from test_torch_exchange import _delta_max, _hook
from test_torch_flash_attention import F32, _qkv

CPU = torch.device("cpu")


# (kind, mixing, G, N, int8 chunk, hops): past the register kernel's 16
# groups, and int8 chunks other than its 256
WIDE_MIX = [("int8", "mean", 32, 1000, 256, 1), ("bf16", "mean", 32, 700, 0, 1),
            ("fp16", "mean", 17, 700, 0, 1), ("thresh", "mean", 32, 700, 0, 1),
            ("int8", "ring", 17, 1000, 256, 2), ("bf16", "gossip", 32, 513, 0, 1),
            ("int8", "mean", 4, 1000, 128, 1), ("int8", "mean", 3, 1000, 37, 1),
            ("int8", "ring", 4, 1100, 512, 2), ("int8", "gossip", 20, 600, 128, 1)]


@pytest.mark.parametrize("kind,topo,G,N,chunk,hops", WIDE_MIX)
def test_codec_mix_matches_reference_at_any_g_and_chunk(kind, topo, G, N,
                                                        chunk, hops):
    """The port's plain epilogue against the reference's staged path and
    its Pallas kernel in interpret mode: bit-equal on the mean at a
    power-of-two G, else within a few ulp (the reference multiplies by 1/G
    and contracts W in XLA's order), a codec quantum on a few elements
    from the second hop on."""
    rs = np.random.RandomState(G * 1000 + N)
    x0 = rs.randn(G, N).astype(np.float32)
    x = x0 + (rs.randn(G, N) * 0.01).astype(np.float32)
    w = None if topo == "mean" else jtopo.mixing_matrix(topo, G, seed=0)
    nh = hops if w is not None else 1
    u = res = tau = None
    if kind == "int8":
        u = rs.rand(nh, G * -(-N // chunk), chunk).astype(np.float32)
    if kind == "thresh":
        res = (rs.randn(G, N) * 0.005).astype(np.float32)
        c = np.abs((x - x0) + res)
        tau = np.sort(c, axis=1)[:, -(N // 10)][:, None].astype(np.float32)
    kw = dict(kind=kind, w=w, hops=hops, chunk=chunk)
    t = (lambda a: None if a is None else torch.tensor(a))
    j = (lambda a: None if a is None else jnp.asarray(a))
    before = dict(ee.launches)
    got, got_res = ee.codec_mix(t(x), t(x0), u=t(u), residual=t(res),
                                tau=t(tau), **kw)
    assert ee.launches == before            # the plain version ran
    got = got.numpy()
    delta = np.abs(x).max() + np.abs(x0).max()
    for impl in ("jnp", "pallas"):
        want, want_res = jee.codec_mix(j(x), j(x0), u=j(u), residual=j(res),
                                       tau=j(tau), impl=impl, **kw)
        if impl == "jnp" and topo == "mean" and G in (1, 2, 4, 8):
            np.testing.assert_array_equal(got, np.asarray(want))
        elif hops == 1:
            np.testing.assert_allclose(got, np.asarray(want), **ULP)
        else:
            assert_close_up_to_flips(got, want, kind, delta)
        if kind == "thresh":
            np.testing.assert_array_equal(got_res.numpy(),
                                          np.asarray(want_res))


@pytest.mark.parametrize("topo,codec,g,chunk", [
    ("server", "int8", 32, 256), ("ring", "int8", 32, 256),
    ("gossip", "bf16", 32, 256), ("server", "topk", 32, 256),
    ("server", "int8", 4, 128), ("ring", "int8", 4, 512),
    ("server", "int8", 16, 256), ("gossip", "fp16", 8, 256),
    ("server", "topk", 4, 256), ("server", "int8z", 4, 256),
    ("async_stale", "int8", 4, 256)])
def test_fusable_takes_any_g_and_chunk(topo, codec, g, chunk):
    """The fused epilogue covers its kinds and topologies whatever G and
    the int8 chunk are, as in the reference."""
    ex = exchange.get_exchange(topo, codec, g, chunk=chunk)
    fits = (codec in ("int8", "fp16", "bf16", "topk")
            and topo in ("server", "ring", "gossip")
            and (codec != "topk" or topo == "server"))
    assert ex._fusable(ex.codec, torch.zeros(g, 8)) is fits
    jex = jexchange.get_exchange(topo, codec, g, chunk=chunk)
    assert jex._fusable(jex.codec, jnp.zeros((g, 8), jnp.float32)) is fits


@pytest.mark.parametrize("codec", ["fp16", "bf16", "int8", "topk"])
def test_exchange_impl_reaches_the_fused_epilogue(codec):
    """The exchange's ``impl`` (the launchers' ``--impl``) reaches
    ``codec_mix`` through every fused codec, the casts included: ``cuda``
    on a CPU buffer raises rather than run the plain version."""
    assert exchange.get_exchange("server", codec, 4,
                                 impl="torch").codec.impl == "torch"
    ex = exchange.get_exchange("server", codec, 4, impl="cuda")
    x0 = torch.zeros(4, 512)
    with pytest.raises(ValueError, match="impl='cuda'"):
        ex.streams({"params": x0 + 1.0}, {"params": x0}, ex.init(x0))


@pytest.mark.parametrize("topo,codec,g,chunk,fused", [
    ("server", "int8", 32, 256, False), ("server", "int8", 32, 256, True),
    ("ring", "int8", 32, 256, False), ("server", "topk", 32, 256, False),
    ("server", "int8", 4, 128, False), ("server", "int8", 4, 128, True)])
def test_exchange_matches_reference(topo, codec, g, chunk, fused):
    """Two rounds of the params stream through the port's exchange (the
    staged codecs, and the fused plain epilogue, the route these streams
    take) against the reference's, with its noise."""
    n, seed = 701, 5
    kw = dict(mix_rounds=2 if topo == "ring" else 1, seed=seed, chunk=chunk)
    port = exchange.get_exchange(topo, codec, g, fused=fused,
                                 noise_hook=_hook, **kw)
    jref_ex = jexchange.get_exchange(topo, codec, g, impl="jnp", **kw)
    rs = np.random.RandomState(7)
    start = np.repeat(rs.randn(1, n).astype(np.float32), g, axis=0)
    pcur, jcur = torch.tensor(start), jnp.asarray(start)
    pstate, jstate = port.init(pcur), jref_ex.init(jcur)
    for _ in range(2):
        delta = (rs.randn(g, n) * 0.01).astype(np.float32)
        px0, jx0 = pcur.clone(), jcur
        pxs, jxs = pcur + torch.tensor(delta), jcur + jnp.asarray(delta)
        x_np = np.asarray(jxs)
        pout, pstate = port.streams({"params": pxs}, {"params": px0}, pstate)
        jout, jstate = jref_ex.streams({"params": jxs}, {"params": jx0},
                                       jstate)
        pcur, jcur = pout["params"], jout["params"]
        assert_close_up_to_flips(pcur.numpy(), jcur, "int8",
                                 _delta_max(x_np, np.asarray(jx0)), frac=0.1)
        st, jst = pstate["codec"]["params"], jstate["codec"]["params"]
        if "count" in st:
            assert int(st["count"]) == int(jst["count"])
        if "residual" in st:
            assert_close_up_to_flips(st["residual"].numpy(), jst["residual"],
                                     "int8", 1.0, frac=0.1)
    assert port.wire_bytes_per_round(n) == jref_ex.wire_bytes_per_round(n)


@pytest.mark.parametrize("chunk", [128, 512, 37])
def test_int8_codec_any_chunk_matches_plain_core(chunk):
    """The staged int8 codec at another chunk: its rows are (rows, chunk)
    and its core is ``qdq_int8``'s plain version, bit for bit."""
    rs = np.random.RandomState(chunk)
    delta = torch.tensor((rs.randn(3, 1000) * 0.01).astype(np.float32))
    c = codecs.int8(chunk=chunk, seed=1)
    got, st = c.compress(delta, c.init(delta))
    rows = torch.nn.functional.pad(delta, (0, -1000 % chunk)).reshape(-1, chunk)
    u = c.noise(0, tuple(rows.shape), CPU)
    want = ref.qdq_int8_ref(rows, u).reshape(3, -1)[:, :1000]
    assert torch.equal(got, want) and int(st["count"]) == 1


def _attention_configs():
    """(name, hd, g, reaches decode) of every reference config whose
    attention reaches the kernels: every family but the ssm one (xlstm
    runs its own cells); vlm prefill only (the reference refuses vlm
    decode)."""
    return [(name, c.resolved_head_dim, c.n_heads // c.n_kv_heads,
             c.family != "vlm")
            for name, c in sorted(all_configs().items())
            if c.family != "ssm"]


@pytest.mark.parametrize("name,hd,g,decodes", _attention_configs())
def test_reference_configs_are_admitted(name, hd, g, decodes):
    assert fa.takes(hd), name
    assert fa.kernel_width(hd) >= hd
    if decodes:
        assert da.takes(hd, g), name


def test_admitted_sets():
    assert [fa.kernel_width(hd) for hd in (1, 8, 9, 40, 64, 65, 96, 112, 113,
                                           128)] == [8, 8, 16, 64, 64, 112,
                                                     112, 112, 128, 128]
    assert not fa.takes(0) and not fa.takes(129) and not fa.takes(512)
    assert da.takes(112, 16) and da.takes(1, 1) and da.takes(128, 3)
    assert not da.takes(129, 1) and not da.takes(64, 17) \
        and not da.takes(64, 0)


@pytest.mark.parametrize("B,H,KV,S,hd", [
    (1, 4, 2, 128, 112), (1, 2, 2, 64, 40), (1, 6, 1, 128, 64)])
def test_flash_matches_reference_at_new_geometries(B, H, KV, S, hd):
    q, k, v = _qkv((B, H, S, hd), seed=hd, kv_heads=KV)
    got = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             block_q=64, block_k=64).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    if KV != H:
        jk, jv = (jnp.repeat(t, H // KV, axis=1) for t in (jk, jv))
    np.testing.assert_allclose(
        got, np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=True)),
        **F32)
    np.testing.assert_allclose(
        got, np.asarray(jflash(jq, jk, jv, block_q=64, block_k=64,
                               interpret=True)), **F32)


@pytest.mark.parametrize("B,n_kv,g,hd,ps,nblk", [
    (3, 2, 3, 16, 4, 5), (2, 8, 6, 32, 4, 3), (2, 2, 16, 16, 4, 4),
    (2, 2, 1, 112, 4, 3), (1, 1, 16, 112, 8, 2)])
def test_decode_matches_reference_at_new_geometries(B, n_kv, g, hd, ps,
                                                    nblk):
    q, pool, rows_k, rows_v, lengths = decode_case(B, n_kv, g, hd, ps, nblk)
    got = decode_port(q, pool, rows_k, rows_v, lengths, ps, n_kv).numpy()
    args = tuple(jnp.asarray(a) for a in (q, pool, rows_k, rows_v, lengths))
    np.testing.assert_allclose(got, np.asarray(jda.paged_decode_attention_ref(
        *args, page_size=ps, n_kv=n_kv)), **DECODE_TOL)
    np.testing.assert_allclose(got, np.asarray(jda.paged_decode_attention(
        *args, page_size=ps, n_kv=n_kv, interpret=True)), **DECODE_TOL)


@pytest.mark.parametrize("hd", [1, 40, 100, 112, 120])
def test_zero_padding_the_head_dim_is_exact(hd):
    """What the wrapper does on the card for an hd between instantiations:
    zero columns up to ``kernel_width(hd)``, the scores scaled by the true
    hd, the padded columns cut. In float64 the padded and the unpadded
    plain versions agree to the last bits of the float64 sums."""
    q, k, v = (torch.from_numpy(a).double() for a in _qkv((1, 3, 96, hd),
                                                          seed=hd))
    width = fa.kernel_width(hd)
    qp, kp, vp = (fa.pad_head_dim(t, width) for t in (q, k, v))
    assert qp.shape[-1] == width and bool((qp[..., hd:] == 0).all())
    got = ref.flash_attention_ref(qp, kp, vp, hd=hd)
    assert bool((got[..., hd:] == 0).all())
    torch.testing.assert_close(got[..., :hd], ref.flash_attention_ref(q, k, v),
                               rtol=1e-13, atol=1e-15)
