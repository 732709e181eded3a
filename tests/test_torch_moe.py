"""The port's MoE layer (``repro_torch/models/moe.py``) against the
reference's on the same params and inputs: the router's expert indices
integer for integer (ties included), its gates and Switch aux loss, the
densemask and dispatch forwards (capacity drops included, and the
capacity rounded to 128 past 128), the one-token decode, and the
gradient through the gates (the moe models' loss and gradient are in
``test_torch_families.py``).

The params are the reference's (``init_params`` from a PRNGKey) at the
granite-moe and phi3.5-moe reductions (4 experts, top 2, d 256), carried
across as numpy. Tolerance: indices and keep masks exact; outputs, gates
and aux rtol 1e-5 / atol 1e-6 (float32, products summed in another order
by XLA and PyTorch)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import moe as jmoe
from repro.models.layers import init_params
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.models import moe

TOL = dict(rtol=1e-5, atol=1e-6)
ARCHS = ("granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b")


def _setup(arch, B=2, S=16, seed=0, **changes):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **changes)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    p = jax.device_get(init_params(jmoe.moe_defs(jcfg),
                                   jax.random.PRNGKey(seed)))
    x = np.random.RandomState(seed + 1).randn(
        B, S, jcfg.d_model).astype(np.float32)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, p),
            bridge.params_from_numpy(p), x)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_indices_gates_and_aux_equal_reference(arch):
    jcfg, tcfg, jp, tp, x = _setup(arch, S=64)
    jg, ji, jaux = jmoe.router(jp, jnp.asarray(x), jcfg)
    tg, ti, taux = moe.router(tp, torch.tensor(x), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)


def test_router_breaks_ties_toward_the_lower_index():
    """A zero router gives every expert the same probability: both
    packages pick experts 0..k-1, in order, for every token."""
    jcfg, tcfg, jp, tp, x = _setup(ARCHS[0], S=8)
    jp = dict(jp, w_router=np.zeros_like(jp["w_router"]))
    tp = dict(tp, w_router=torch.zeros_like(tp["w_router"]))
    _, ji, _ = jmoe.router(jp, jnp.asarray(x), jcfg)
    _, ti, _ = moe.router(tp, torch.tensor(x), tcfg)
    want = np.broadcast_to(np.arange(tcfg.top_k), ti.shape)
    np.testing.assert_array_equal(np.asarray(ji), want)
    np.testing.assert_array_equal(ti.numpy(), want)
    vals, idx = moe.top_k(torch.tensor([[0.5, 0.2, 0.5, 0.5]]), 3)
    assert idx.tolist() == [[0, 2, 3]] and vals.tolist() == [[0.5] * 3]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["densemask", "dispatch"])
def test_moe_forward_equals_reference(arch, impl):
    jcfg, tcfg, jp, tp, x = _setup(arch, moe_impl=impl)
    jy, jaux = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    ty, taux = moe.moe_forward(tp, torch.tensor(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)


def _skewed(jp, tp, x, expert=0, scale=50.0):
    """A router that sends every token to ``expert`` first: its column
    along the tokens' mean direction, so the expert's queue overflows."""
    col = x.reshape(-1, x.shape[-1]).mean(0)
    col = scale * col / np.linalg.norm(col)
    w = np.array(jp["w_router"])
    w[:, expert] = col
    return (dict(jp, w_router=jnp.asarray(w)),
            dict(tp, w_router=torch.tensor(w)))


def test_dispatch_drops_overflow_as_the_reference():
    """T 32, K 2, E 4: capacity int(2*32*1.25/4) = 20 slots an expert; a
    router skewed to expert 0 overflows its queue. The dropped entries
    (scale 0, parked on slot C-1) give the same output in both
    packages, and it differs from densemask's."""
    jcfg, tcfg, jp, tp, x = _setup(ARCHS[0], moe_impl="dispatch")
    jp, tp = _skewed(jp, tp, x)
    _, ti, _ = moe.router(tp, torch.tensor(x), tcfg)
    assert moe.capacity(32, tcfg) == 20
    assert int((ti == 0).sum()) > 20                  # the queue overflows
    jy, _ = jmoe.moe_dispatch(jp, jnp.asarray(x), jcfg)
    ty, _ = moe.moe_dispatch(tp, torch.tensor(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    dense, _ = moe.moe_densemask(tp, torch.tensor(x), tcfg)
    assert not np.allclose(ty.numpy(), dense.numpy(), **TOL)


def test_dispatch_capacity_rounds_to_128_past_128():
    """T 512: int(2*512*1.25/4) = 320 slots, rounded up to 384."""
    jcfg, tcfg, jp, tp, x = _setup(ARCHS[1], B=2, S=256, moe_impl="dispatch")
    assert moe.capacity(512, tcfg) == 384
    assert moe.capacity(10, tcfg) == 6 and moe.capacity(1, tcfg) == 1
    jy, jaux = jmoe.moe_dispatch(jp, jnp.asarray(x), jcfg)
    ty, taux = moe.moe_dispatch(tp, torch.tensor(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mlp_type", ["swiglu", "relu2", "gelu"])
def test_moe_decode_equals_reference(arch, mlp_type):
    jcfg, tcfg, jp, tp, x = _setup(arch, B=5, S=1, mlp_type=mlp_type)
    jy, jaux = jmoe.moe_decode(jp, jnp.asarray(x), jcfg)
    ty, taux = moe.moe_decode(tp, torch.tensor(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)
    # one token: the decode path equals densemask on the same token
    dense, _ = moe.moe_densemask(tp, torch.tensor(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), dense.numpy(), **TOL)


def test_moe_grad_flows_to_router_and_every_chosen_expert():
    """The densemask forward is differentiable through the gates: the
    router and the experts the tokens chose get nonzero gradients, an
    expert no token chose gets none."""
    _, tcfg, _, tp, x = _setup(ARCHS[0], S=4)
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    y, aux = moe.moe_forward(tp, torch.tensor(x), tcfg)
    (y.square().sum() + aux).backward()
    _, idx, _ = moe.router(tp, torch.tensor(x), tcfg)
    chosen = set(idx.reshape(-1).tolist())
    assert tp["w_router"].grad.abs().sum() > 0
    for e in range(tcfg.n_experts):
        nz = bool(tp["w_up"].grad[e].abs().sum() > 0)
        assert nz == (e in chosen), (e, chosen)
