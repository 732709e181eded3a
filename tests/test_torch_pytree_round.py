"""The pytree local-SGD round, the packed round's microbatch mode and both
sync steps: the port against the reference's jitted functions on the same
inputs (numpy draws from a seed; the paper-mlp reduction from the
reference's params).

Models: the (r=24, d=32) least-squares quadratic of
``tests/test_exchange_engine.py`` (G=4 groups, each its own (A, b) with a
common solution) and a paper-mlp reduction. Tolerances: float32 params
and metrics rtol 1e-5 / atol 1e-6 on the quadratic (a few dozen steps,
each a handful of float32 ops whose sums run in another order), rtol
2e-4 / atol 1e-6 on the model as in ``tests/test_torch_localsgd.py``
(adamw's params atol 1e-5, for the reason given there). Step counts,
threshold inner counts, wire bytes and the metric keys are exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro import optim as joptim
from repro.configs.base import get_config as jax_get_config
from repro.core import localsgd as jlsgd
from repro.data.synthetic import TokenPipeline as JaxTokenPipeline
from repro.models import build_model as jax_build_model
from repro.optim import packing as jpacking
from repro_torch import bridge, comm, optim, tree
from repro_torch.configs.base import get_config
from repro_torch.core import localsgd as lsgd
from repro_torch.models.api import build_model
from repro_torch.optim import packing

G, R, D = 4, 24, 32
TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=2e-4, atol=1e-6)
LR = {"sgd": 0.4, "momentum": 0.1, "adamw": 0.02}


def quad_loss_j(params, batch):
    r = batch["A"] @ params["w"] - batch["b"]
    return 0.5 * jnp.sum(r ** 2)


def quad_loss_t(params, batch):
    r = batch["A"] @ params["w"] - batch["b"]
    return 0.5 * torch.sum(r ** 2)


def quadratic(seed=0, g=G, r=R, d=D, micro_t=None):
    """(params, batch) as numpy float32: each group's (A, b) shares the
    solution w*; with ``micro_t`` the batch has a (G, T) microbatch axis."""
    rng = np.random.RandomState(seed)
    lead = (g,) if micro_t is None else (g, micro_t)
    A = (rng.randn(*lead, r, d) / np.sqrt(d)).astype(np.float32)
    w_star = rng.randn(d).astype(np.float32)
    b = np.einsum("...rd,d->...r", A, w_star).astype(np.float32)
    w0 = rng.randn(d).astype(np.float32)
    return {"w": w0}, {"A": A, "b": b}


def run_ref(params, batch, opt, cfg, rounds, exchange=None, layout=None):
    rnd = jax.jit(jlsgd.make_local_round(quad_loss_j, opt, cfg,
                                         layout=layout, exchange=exchange))
    state = jlsgd.init_state(params, opt, n_groups=cfg.n_groups,
                             layout=layout)
    jb = jax.tree.map(jnp.asarray, batch)
    ms = []
    for _ in range(rounds):
        state, m = rnd(state, jb)
        ms.append(jax.device_get(m))
    return jax.device_get(state), ms


def run_port(params, batch, opt, cfg, rounds, exchange=None, layout=None,
             loss=quad_loss_t):
    rnd = lsgd.make_local_round(loss, opt, cfg, layout=layout,
                                exchange=exchange)
    state = lsgd.init_state(bridge.params_from_numpy(params), opt,
                            cfg.n_groups, layout)
    tb = bridge.params_from_numpy(batch)
    ms = []
    for _ in range(rounds):
        state, m = rnd(state, tb)
        ms.append(m)
    return state, ms


def assert_metrics(jms, tms, tol=TOL):
    for jm, tm in zip(jms, tms):
        assert set(tm) == set(jm)
        for k, jv in jm.items():
            tv = tm[k]
            if k.startswith("wire_bytes") or k == "inner_steps":
                np.testing.assert_array_equal(np.asarray(tv), np.asarray(jv),
                                              err_msg=k)
            else:
                np.testing.assert_allclose(np.asarray(tv), np.asarray(jv),
                                           err_msg=k, **tol)


def assert_tree(jtree, ttree, tol=TOL):
    flat_j = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert len(flat_j) == len(jax.tree.leaves(jtree))
    for path, jv in flat_j:
        tv = ttree
        for p in path:
            tv = tv[p.key]
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                   err_msg=str(path), **tol)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
@pytest.mark.parametrize("mode", ["fixed", "t_i", "microbatch"])
def test_tree_round_matches_reference(name, mode):
    T = 3
    params, batch = quadratic(1, micro_t=T if mode == "microbatch" else None)
    kw = dict(n_groups=G, inner_steps=T,
              t_i=(0, 3, 1, 2) if mode == "t_i" else None,
              inner_mode="microbatch" if mode == "microbatch" else
              "fixed_batch")
    js, jms = run_ref(params, batch, joptim.get(name, LR[name]),
                      jlsgd.LocalSGDConfig(**kw), 3)
    ts, tms = run_port(params, batch, optim.get(name, LR[name]),
                       lsgd.LocalSGDConfig(**kw), 3)
    assert_tree(js["params"], ts["params"])
    assert_tree(js["opt"], ts["opt"])
    assert_metrics(jms, tms)
    # the count is per group and never exchanged
    np.testing.assert_array_equal(ts["opt"]["count"].numpy(),
                                  np.asarray(js["opt"]["count"]))


@pytest.mark.parametrize("topology", ["server", "ring", "gossip", "none"])
def test_tree_round_topologies_match_reference(topology):
    params, batch = quadratic(2)
    cfg = dict(n_groups=G, inner_steps=2)
    jex = jcomm.get_exchange(topology, "fp32", G, mix_rounds=2)
    tex = comm.get_exchange(topology, "fp32", G, mix_rounds=2)
    js, jms = run_ref(params, batch, joptim.momentum(0.1),
                      jlsgd.LocalSGDConfig(**cfg), 3, exchange=jex)
    ts, tms = run_port(params, batch, optim.momentum(0.1),
                       lsgd.LocalSGDConfig(**cfg), 3, exchange=tex)
    assert_tree(js["params"], ts["params"])
    assert_tree(js["opt"]["mu"], ts["opt"]["mu"])
    assert_metrics(jms, tms)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
def test_tree_threshold_counts_match_reference(name):
    """Threshold mode over 3 rounds: every group's inner count equal to the
    reference's, integer for integer; group 1 starts at its own optimum
    (|g(w0)|^2 = 0 <= eps), so it takes no step in round 1."""
    params, batch = quadratic(3, g=3, r=3, d=8)
    batch["b"][1] = batch["A"][1] @ params["w"]
    lr = {"sgd": 0.2, "momentum": 0.05, "adamw": 0.01}[name]
    cfg = dict(n_groups=3, inner_steps=1, threshold=1e-6, max_inner=400)
    js, jms = run_ref(params, batch, joptim.get(name, lr),
                      jlsgd.LocalSGDConfig(**cfg), 3)
    ts, tms = run_port(params, batch, optim.get(name, lr),
                       lsgd.LocalSGDConfig(**cfg), 3)
    assert int(tms[0]["inner_steps"][1]) == 0
    assert_metrics(jms, tms)
    assert_tree(js["params"], ts["params"])


def test_tree_threshold_stops_at_eps_and_respects_cap():
    """The reference's ``tests/test_localsgd.py`` threshold cases on the
    port: stop at ||g||^2 <= eps in more than one step, and the cap."""
    params, batch = quadratic(4, g=2, r=3, d=8)
    opt = optim.sgd(0.2)
    rnd = lsgd.make_local_round(quad_loss_t, opt, lsgd.LocalSGDConfig(
        n_groups=2, inner_steps=1, threshold=1e-8, max_inner=10_000))
    st = lsgd.init_state(bridge.params_from_numpy(params), opt, 2)
    _, m = rnd(st, bridge.params_from_numpy(batch))
    assert bool(torch.all(m["grad_sq"] <= 1e-8))
    assert bool(torch.all((m["inner_steps"] > 1)
                          & (m["inner_steps"] < 10_000)))
    assert set(m) >= {"loss", "inner_steps", "grad_sq"}
    assert "grad_sq_traj" not in m and "grad_sq_first" not in m
    opt = optim.sgd(1e-4)
    rnd = lsgd.make_local_round(quad_loss_t, opt, lsgd.LocalSGDConfig(
        n_groups=2, inner_steps=1, threshold=1e-20, max_inner=5))
    st = lsgd.init_state(bridge.params_from_numpy(params), opt, 2)
    _, m = rnd(st, bridge.params_from_numpy(batch))
    assert m["inner_steps"].tolist() == [5, 5]


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
def test_tree_round_50_rounds_stay_close(name):
    """50 rounds of the quadratic (T=4, server/fp32): params, loss and
    grad_sq allclose to the reference's all along (rtol 1e-4 / atol 1e-6
    over 200 local steps; grad_sq rtol 1e-3 / atol 1e-9: near the solution
    the residual A w - b cancels, so each gradient entry carries ~1e-6 of
    float32 rounding in either framework)."""
    params, batch = quadratic(5)
    cfg = dict(n_groups=G, inner_steps=4)
    js, jms = run_ref(params, batch, joptim.get(name, LR[name]),
                      jlsgd.LocalSGDConfig(**cfg), 50)
    ts, tms = run_port(params, batch, optim.get(name, LR[name]),
                       lsgd.LocalSGDConfig(**cfg), 50)
    tol = dict(rtol=1e-4, atol=1e-6)
    assert_tree(js["params"], ts["params"], tol)
    for jm, tm in zip(jms, tms):
        np.testing.assert_allclose(tm["loss"].numpy(), jm["loss"], **tol)
        np.testing.assert_allclose(tm["grad_sq"].numpy(), jm["grad_sq"],
                                   rtol=1e-3, atol=1e-9)


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_packed_microbatch_matches_reference(name):
    T = 3
    params, batch = quadratic(6, micro_t=T)
    cfg = dict(n_groups=G, inner_steps=T, inner_mode="microbatch")
    jlayout = jpacking.layout_of(jax.tree.map(jnp.asarray, params))
    js, jms = run_ref(params, batch,
                      joptim.packed(name, LR[name], impl="pallas"),
                      jlsgd.LocalSGDConfig(**cfg), 3, layout=jlayout)
    tp = bridge.params_from_numpy(params)
    for metrics in ("final", "traj"):
        if metrics == "traj":
            js, jms = run_ref(params, batch,
                              joptim.packed(name, LR[name], impl="pallas"),
                              jlsgd.LocalSGDConfig(**cfg, metrics="traj"), 3,
                              layout=jlayout)
        ts, tms = run_port(params, batch, optim.packed(name, LR[name]),
                           lsgd.LocalSGDConfig(**cfg, metrics=metrics), 3,
                           layout=packing.layout_of(tp))
        np.testing.assert_allclose(ts["params"].numpy(),
                                   np.asarray(js["params"]), **TOL)
        assert_metrics(jms, tms)


def test_packed_refuses_threshold_and_microbatch_t_i():
    params, _ = quadratic(0)
    tp = bridge.params_from_numpy(params)
    layout, opt = packing.layout_of(tp), optim.packed("sgd", 0.1)
    with pytest.raises(NotImplementedError, match="pytree path"):
        lsgd.make_local_round(quad_loss_t, opt, lsgd.LocalSGDConfig(
            n_groups=2, inner_steps=2, threshold=1e-3), layout=layout)
    with pytest.raises(NotImplementedError, match="fixed_batch"):
        lsgd.make_local_round(quad_loss_t, opt, lsgd.LocalSGDConfig(
            n_groups=2, inner_steps=2, t_i=(1, 2), inner_mode="microbatch"),
            layout=layout)
    with pytest.raises(ValueError, match="BOTH"):
        lsgd.make_local_round(quad_loss_t, optim.sgd(0.1),
                              lsgd.LocalSGDConfig(n_groups=2), layout=layout)


def test_tree_round_refuses_lossy_exchanges():
    """int8/int8z/top-k need the flat buffer (the reference refuses them
    too); the cast codecs and async_stale run on the tree path
    (``test_tree_round_runs_the_cast_codecs_and_async_stale``)."""
    cfg = lsgd.LocalSGDConfig(n_groups=G)
    opt = optim.sgd(0.1)
    for kw, match in (({"codec": "int8"}, "packed"),
                      ({"codec": "topk"}, "packed"),
                      ({"codec": "int8z"}, "packed")):
        ex = comm.get_exchange(**{"topology": "server", "n_groups": G, **kw})
        with pytest.raises(NotImplementedError, match=match):
            lsgd.make_local_round(quad_loss_t, opt, cfg, exchange=ex)
    # nothing on the wire: the codecs never run
    lsgd.make_local_round(quad_loss_t, opt, cfg, exchange=comm.get_exchange(
        "none", "int8", G))


@pytest.mark.parametrize("name,kw", [
    ("sgd", {"codec": "bf16"}),
    ("momentum", {"moment_codec": "fp16"}),
    ("sgd", {"downlink_codec": "bf16"}),
    ("momentum", {"topology": "async_stale"}),
])
def test_tree_round_runs_the_cast_codecs_and_async_stale(name, kw):
    """The cells ``test_tree_round_refuses_lossy_exchanges`` once refused,
    against the reference's pytree round over 3 rounds: params and
    moments within one ulp of the codec at the values' magnitude (2**-7
    bf16, 2**-10 fp16: a last-bit difference can move a cast by one codec
    step), TOL on the fp32 wire; wire bytes, step counts and the metric
    keys exact (``tests/test_torch_tree_exchange.py`` holds the whole
    exchange)."""
    params, batch = quadratic(9)
    cfg = dict(n_groups=G, inner_steps=2)
    ekw = {"topology": "server", "n_groups": G, **kw}
    jex, tex = jcomm.get_exchange(**ekw), comm.get_exchange(**ekw)
    jopt, topt = joptim.get(name, LR[name]), optim.get(name, LR[name])
    jrnd = jax.jit(jlsgd.make_local_round(
        quad_loss_j, jopt, jlsgd.LocalSGDConfig(**cfg), exchange=jex))
    jst = jlsgd.init_state(jax.tree.map(jnp.asarray, params), jopt,
                           n_groups=G, exchange=jex)
    trnd = lsgd.make_local_round(quad_loss_t, topt,
                                 lsgd.LocalSGDConfig(**cfg), exchange=tex)
    tst = lsgd.init_state(bridge.params_from_numpy(params), topt, G,
                          exchange=tex)
    ulp = {"bf16": 2.0 ** -7, "fp16": 2.0 ** -10}.get(
        next(iter(kw.values())))
    jb, tb = jax.tree.map(jnp.asarray, batch), bridge.params_from_numpy(batch)
    for _ in range(3):
        jst, jm = jrnd(jst, jb)
        tst, tm = trnd(tst, tb)
        js, jm = jax.device_get(jst), jax.device_get(jm)
        moments = [k for k in tst["opt"] if k != "count"]
        for jv, tv in zip(
                jax.tree.leaves({"params": js["params"],
                                 **{k: js["opt"][k] for k in moments}}),
                tree.leaves({"params": tst["params"],
                             **{k: tst["opt"][k] for k in moments}})):
            tol = TOL if ulp is None else dict(
                rtol=ulp, atol=ulp * float(np.abs(jv).max()))
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **tol)
        assert set(tm) == set(jm)
        for k, jv in jm.items():
            if k.startswith("wire_bytes") or k == "inner_steps":
                np.testing.assert_array_equal(np.asarray(tm[k]),
                                              np.asarray(jv), err_msg=k)
    assert set(tst.get("comm", {})) == set(js.get("comm", {}))


@pytest.mark.parametrize("packed", [False, True])
def test_sync_step_matches_reference(packed):
    params, batch = quadratic(7)
    b0 = {"A": batch["A"][0], "b": batch["b"][0]}
    jparams = jax.tree.map(jnp.asarray, params)
    jlayout = jpacking.layout_of(jparams) if packed else None
    jopt = (joptim.packed("adamw", 0.01, impl="pallas") if packed
            else joptim.adamw(0.01))
    jst = jlsgd.init_state(jparams, jopt, layout=jlayout)
    jstep = jax.jit(jlsgd.make_sync_step(quad_loss_j, jopt, layout=jlayout))
    tp = bridge.params_from_numpy(params)
    layout = packing.layout_of(tp) if packed else None
    opt = optim.packed("adamw", 0.01) if packed else optim.adamw(0.01)
    st = lsgd.init_state(tp, opt, layout=layout)
    step = lsgd.make_sync_step(quad_loss_t, opt, layout=layout)
    tb = bridge.params_from_numpy(b0)
    for _ in range(3):
        jst, jm = jstep(jst, jax.tree.map(jnp.asarray, b0))
        st, m = step(st, tb)
        assert set(m) == set(jm) == {"loss", "grad_sq"}
        for k in m:
            np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]),
                                       **TOL)
    if packed:
        assert st["params"].shape == (layout.size,)
        np.testing.assert_allclose(st["params"].numpy(),
                                   np.asarray(jst["params"]), **TOL)
    else:
        assert_tree(jax.device_get(jst["params"]), st["params"])
    assert int(st["opt"]["count"]) == 3


def test_t1_round_equals_sync_step():
    """A pytree round at T=1 over server/fp32 is one sync step on the mean
    of the group losses (the reference's tests/test_localsgd.py check, at
    its rtol 1e-5)."""
    params, batch = quadratic(8)
    tp, tb = bridge.params_from_numpy(params), bridge.params_from_numpy(batch)
    opt = optim.sgd(0.1)
    rnd = lsgd.make_local_round(quad_loss_t, opt,
                                lsgd.LocalSGDConfig(n_groups=G))
    out_l, _ = rnd(lsgd.init_state(tp, opt, G), tb)

    def global_loss(p, b):
        return torch.stack([quad_loss_t(p, {"A": b["A"][g], "b": b["b"][g]})
                            for g in range(G)]).mean()

    step = lsgd.make_sync_step(global_loss, opt)
    out_s, _ = step(lsgd.init_state(tp, opt), tb)
    np.testing.assert_allclose(out_l["params"]["w"][0].numpy(),
                               out_s["params"]["w"].numpy(), rtol=1e-5,
                               atol=1e-6)


SMALL = dict(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256)


@pytest.fixture(scope="module")
def mlp():
    jcfg = dataclasses.replace(jax_get_config("paper-mlp").reduced(), **SMALL)
    tcfg = dataclasses.replace(get_config("paper-mlp").reduced(), **SMALL)
    jmodel = jax_build_model(jcfg, schedule="rect")
    tmodel = build_model(tcfg, schedule="rect")
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(3)))
    tokens = next(JaxTokenPipeline(jcfg.vocab_size, 16, seed=5).batches(
        (2, 2)))["tokens"]
    return jmodel, tmodel, params, tokens


@pytest.mark.parametrize("mode", ["fixed", "threshold"])
def test_tree_round_on_the_model(mlp, mode):
    """paper-mlp (reduced, narrowed) on the pytree round, G=2, 2 rounds:
    fixed T=2 with sgd, and threshold mode (sgd, eps 1.2: the groups stop
    at different counts below max_inner 8) — counts exact."""
    jmodel, tmodel, params, tokens = mlp
    kw = dict(n_groups=2, inner_steps=2)
    if mode == "threshold":
        kw.update(threshold=1.2, max_inner=8)
    jrnd = jax.jit(jlsgd.make_local_round(jmodel.loss, joptim.sgd(0.5),
                                          jlsgd.LocalSGDConfig(**kw)))
    jst = jlsgd.init_state(params, joptim.sgd(0.5), n_groups=2)
    trnd = lsgd.make_local_round(tmodel.loss, optim.sgd(0.5),
                                 lsgd.LocalSGDConfig(**kw))
    tst = lsgd.init_state(bridge.params_from_numpy(params), optim.sgd(0.5), 2)
    jms, tms = [], []
    for _ in range(2):
        jst, jm = jrnd(jst, {"tokens": jnp.asarray(tokens)})
        tst, tm = trnd(tst, {"tokens": torch.tensor(tokens)})
        jms.append(jax.device_get(jm))
        tms.append(tm)
    assert_metrics(jms, tms, MODEL_TOL)
    assert_tree(jax.device_get(jst["params"]), tst["params"], MODEL_TOL)
    if mode == "threshold":
        counts = [m["inner_steps"].tolist() for m in tms]
        print("threshold inner counts", counts)
        assert all(c < 8 for cs in counts for c in cs)
