"""Overlapped delayed mixing (DESIGN.md §14) in the port against the JAX
package, on the quadratic of ``tests/test_overlap.py`` (numpy-drawn, as in
``test_torch_pytree_round``).

The overlapped packed round mixes the previous round's in-flight payload
before its local steps, applies ``x + (mix(inflight) - inflight)``,
clamps the non-negative moments and puts its result in flight, encoded
against the round start. Held against the reference's jitted round over
5 rounds: server fp32 (sgd, adamw) at rtol 1e-5 / atol 1e-6; the ring
with int8 fed the reference's noise and gossip with bf16 params and int8z
moments at the same tolerance, except that a last-bit difference may move
a rounding by one codec quantum on up to 10% of the elements; the
in-flight payload likewise, the codec counters exact. Round 0 from a
uniform start is purely local; the in-flight state survives
``checkpoint/io`` mid-overlap, bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch import bridge, comm, optim
from repro_torch.core import localsgd as lsgd
from repro_torch.optim import packing
from test_torch_faults import (FP32, _leaves, assert_round_metrics,
                               packed_runs)
from test_torch_pytree_round import quad_loss_t, quadratic

G = 4


@pytest.mark.parametrize("topo,codec,opt_name,kw", [
    ("server", "fp32", "sgd", {}),
    ("server", "fp32", "adamw", {}),
    ("ring", "int8", "sgd", {}),
    ("gossip", "bf16", "momentum", dict(moment_codec="int8z")),
])
def test_overlap_round_matches_reference(topo, codec, opt_name, kw):
    lr = {"sgd": 0.4, "adamw": 0.02, "momentum": 0.1}[opt_name]
    js, jms, ts, tms, _, ex = packed_runs(topo, codec, opt_name, lr, 5,
                                          dict(overlap=True, seed=7, **kw))
    assert ex.overlap and ex.name.endswith("+ov")
    for jst, tst, jm, tm in zip(js, ts, jms, tms):
        inf = tst["comm"]["inflight"]
        assert set(inf) == set(jst["comm"]["inflight"])
        pairs = [(tst["params"], jst["params"])] + [
            (tst["opt"][k], jst["opt"][k]) for k in tst["opt"]
            if k != "count"] + [
            (inf[k], jst["comm"]["inflight"][k]) for k in inf]
        for got, want in pairs:
            want = np.asarray(want)
            if codec == "fp32":
                np.testing.assert_allclose(got.numpy(), want, **FP32)
            else:
                off = ~np.isclose(got.numpy(), want, **FP32)
                assert off.mean() <= 0.1
                np.testing.assert_array_less(
                    np.abs(got.numpy() - want)[off],
                    2 * 2 * np.abs(want).max() / 127.0)
        for s, st in tst["comm"].get("codec", {}).items():
            assert int(st["count"]) == int(jst["comm"]["codec"][s]["count"])
        assert_round_metrics(jm, tm, tol=FP32 if codec == "fp32" else
                             dict(rtol=2e-3, atol=1e-5))
        if opt_name == "adamw":
            assert float(tst["opt"]["v"].min()) >= 0.0


def _round(topo, codec, overlap, opt_name="sgd", lr=0.4):
    params, batch = quadratic(0)
    tp = bridge.params_from_numpy(params)
    layout = packing.layout_of(tp)
    opt = optim.packed(opt_name, lr)
    ex = comm.get_exchange(topo, codec, G, overlap=overlap)
    rnd = lsgd.make_local_round(quad_loss_t, opt, lsgd.LocalSGDConfig(
        n_groups=G, inner_steps=2), layout=layout, exchange=ex)
    return rnd, lsgd.init_state(tp, opt, G, layout, exchange=ex), \
        bridge.params_from_numpy(batch), ex


def test_inflight_state_is_a_copy_of_the_start():
    """init puts a copy of each stream in flight (never a view of the live
    buffer the round updates in place); the round's new payload is a
    copy too."""
    rnd, st, batch, ex = _round("server", "fp32", True, "adamw", 0.02)
    inf = st["comm"]["inflight"]
    assert set(inf) == {"params", "m", "v"}
    for k, v in inf.items():
        live = st["params"] if k == "params" else st["opt"][k]
        torch.testing.assert_close(v, live, rtol=0, atol=0)
        assert v.data_ptr() != live.data_ptr()
    st, _ = rnd(st, batch)
    for k, v in st["comm"]["inflight"].items():
        live = st["params"] if k == "params" else st["opt"][k]
        torch.testing.assert_close(v, live, rtol=0, atol=0)
        assert v.data_ptr() != live.data_ptr()
    assert not comm.get_exchange("ring", "int8", G).overlap


def test_round0_uniform_start_is_pure_local():
    rnd_ov, st_ov, batch, _ = _round("server", "fp32", True)
    rnd_no, st_no, _, _ = _round("none", "fp32", False)
    st_ov, _ = rnd_ov(st_ov, batch)
    st_no, _ = rnd_no(st_no, batch)
    torch.testing.assert_close(st_ov["params"], st_no["params"], rtol=0,
                               atol=0)


def test_delayed_mixing_matches_handrolled_rounds():
    """On the identity codec the round is p' = local(p) + mix(inflight) -
    inflight with inflight' = p', for the server mean and the ring W: the
    none round and the correction by hand give the same bits."""
    for topo in ("server", "ring"):
        rnd_ov, st_ov, batch, ex = _round(topo, "fp32", True)
        rnd_no, st_no, _, _ = _round("none", "fp32", False)
        ref = {"params": st_no["params"].clone(), "opt": st_no["opt"]}
        inflight = st_ov["comm"]["inflight"]["params"].clone()
        for _ in range(4):
            st_ov, _ = rnd_ov(st_ov, batch)
            ref, _ = rnd_no(ref, batch)
            mixed = ex.mix(inflight, out=torch.empty_like(inflight))
            corrected = ref["params"] + (mixed - inflight)
            ref = {"params": corrected.clone(), "opt": ref["opt"]}
            inflight = corrected
            torch.testing.assert_close(st_ov["params"], corrected, rtol=0,
                                       atol=0)
            torch.testing.assert_close(
                st_ov["comm"]["inflight"]["params"], corrected, rtol=0,
                atol=0)


@pytest.mark.parametrize("topo,codec", [("server", "fp32"), ("ring", "int8")])
def test_inflight_checkpoint_roundtrip(topo, codec, tmp_path):
    from repro_torch.checkpoint import io as ckpt_io

    rnd, st, batch, _ = _round(topo, codec, True)
    for _ in range(2):
        st, _ = rnd(st, batch)
    path = str(tmp_path / "ck")
    ckpt_io.save(path, st)
    back = ckpt_io.load(path, st)
    for _ in range(2):
        st, m1 = rnd(st, batch)
        back, m2 = rnd(back, batch)
    for (pa, a), (pb, b) in zip(_leaves(st), _leaves(back)):
        assert pa == pb
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(m1["grad_sq"], m2["grad_sq"], rtol=0, atol=0)


def test_overlap_refusals():
    for topo in ("none", "async_stale", "push_sum"):
        with pytest.raises(NotImplementedError, match="overlap"):
            comm.get_exchange(topo, "fp32", G, overlap=True)
    for kw, match in ((dict(downlink_codec="int8"), "downlink"),
                      (dict(topology="ring", mix_rounds=2), "mix_rounds"),
                      (dict(drop_rate=0.1), "fault"),
                      (dict(dropouts=((1, 0, 2),)), "fault"),
                      (dict(codec="topk"), "topk"),
                      (dict(moment_codec="topk"), "topk"),
                      (dict(topology="hierarchical", n_pods=2),
                       "hierarchical")):
        with pytest.raises(NotImplementedError, match=match):
            comm.get_exchange(**{"topology": "server", "n_groups": G,
                                 "overlap": True, **kw})
    with pytest.raises(NotImplementedError, match="inflight"):
        lsgd.make_local_round(quad_loss_t, optim.sgd(0.1),
                              lsgd.LocalSGDConfig(n_groups=G),
                              exchange=comm.get_exchange("server", "fp32", G,
                                                         overlap=True))
    rnd, st, batch, _ = _round("server", "fp32", True)
    del st["comm"]["inflight"]
    with pytest.raises(ValueError, match="inflight"):
        rnd(st, batch)
