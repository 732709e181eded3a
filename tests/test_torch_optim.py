"""The port's pytree optimizers and the transforms over both kinds
(``clip_by_global_norm``, ``cosine_schedule``, ``with_schedule``) against
the reference's, on the same numpy draws.

Tolerance: float32 rtol 1e-6 / atol 1e-7 after 5 steps (the same float32
ops in the same order; PyTorch and XLA may round a power or a square root
one ulp apart). The schedule's lr values rtol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import bridge, optim

TOL = dict(rtol=1e-6, atol=1e-7)


def tree_and_grads(seed, steps=5):
    rng = np.random.RandomState(seed)
    params = {"a": rng.randn(3, 4).astype(np.float32),
              "b": {"c": rng.randn(5).astype(np.float32)}}
    grads = [{"a": rng.randn(3, 4).astype(np.float32) * 3,
              "b": {"c": rng.randn(5).astype(np.float32) * 3}}
             for _ in range(steps)]
    return params, grads


def run_both(jopt, topt, seed=0):
    params, grads = tree_and_grads(seed)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = bridge.params_from_numpy(params)
    ts = topt.init(tp)
    for g in grads:
        jp, js = jopt.step(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = topt.step(tp, bridge.params_from_numpy(g), ts)
    return (jax.device_get(jp), jax.device_get(js)), (tp, ts)


def assert_same(j, t):
    if isinstance(j, dict):
        assert set(j) == set(t)
        for k in j:
            assert_same(j[k], t[k])
    else:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
def test_pytree_optimizer_matches_reference(name):
    kw = {"weight_decay": 0.01} if name == "adamw" else {}
    (jp, js), (tp, ts) = run_both(joptim.get(name, 0.05, **kw),
                                  optim.get(name, 0.05, **kw))
    assert_same(jp, tp)
    assert_same(js, ts)       # the count and moments mirror the param tree
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 5


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_pytree_matches_reference(max_norm):
    """One global norm over every leaf; binding (0.5) and not (100)."""
    (jp, _), (tp, _) = run_both(
        joptim.clip_by_global_norm(joptim.momentum(0.1), max_norm),
        optim.clip_by_global_norm(optim.momentum(0.1), max_norm))
    assert_same(jp, tp)


def test_cosine_schedule_matches_reference():
    jf = joptim.cosine_schedule(0.3, warmup=4, total=30, min_frac=0.1)
    tf = optim.cosine_schedule(0.3, warmup=4, total=30, min_frac=0.1)
    for c in range(0, 40, 3):
        np.testing.assert_allclose(
            float(tf(torch.tensor(c, dtype=torch.int32))), float(jf(c)),
            rtol=1e-6)


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_with_schedule_pytree_matches_reference(name):
    jsched = joptim.cosine_schedule(0.1, warmup=2, total=20)
    tsched = optim.cosine_schedule(0.1, warmup=2, total=20)
    jopt = joptim.with_schedule(lambda lr: joptim.get(name, lr), jsched)
    topt = optim.with_schedule(lambda lr: optim.get(name, lr), tsched)
    assert topt.count_dependent and not topt.packed
    (jp, _), (tp, _) = run_both(jopt, topt)
    assert_same(jp, tp)


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_packed_transforms_match_reference(name):
    """with_schedule over a packed optimizer under a binding per-group
    clip, on a (G, N) buffer (and the packed/impl flags kept), then on one
    (N,) buffer — the sync step's state."""
    rng = np.random.RandomState(1)
    sched_j = joptim.cosine_schedule(0.05, warmup=2, total=20)
    sched_t = optim.cosine_schedule(0.05, warmup=2, total=20)
    jopt = joptim.clip_by_global_norm(joptim.with_schedule(
        lambda lr: joptim.packed(name, lr, impl="pallas"), sched_j), 0.5)
    topt = optim.clip_by_global_norm(optim.with_schedule(
        lambda lr: optim.packed(name, lr), sched_t), 0.5)
    assert topt.packed and topt.count_dependent and topt.impl == "auto"
    for shape in ((3, 37), (37,)):
        buf = rng.randn(*shape).astype(np.float32)
        jb, js = jnp.asarray(buf), jopt.init(jnp.asarray(buf))
        tb = torch.tensor(buf)
        ts = topt.init(tb)
        for _ in range(4):
            g = rng.randn(*shape).astype(np.float32)
            jb, js = jopt.step(jb, jnp.asarray(g), js)
            tb, ts = topt.step(tb, torch.tensor(g), ts)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)


def test_get_refuses_impl_for_pytree_optimizers():
    with pytest.raises(ValueError, match="packed=True"):
        optim.get("sgd", 0.1, impl="cuda")
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.get("lion", 0.1)
    assert not optim.get("adamw", 0.1).packed
    assert optim.get("adamw", 0.1, packed=True).packed
