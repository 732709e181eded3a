"""The slice as a whole: the port's packed local-SGD round against the
reference's, over 3 rounds of a paper-mlp reduction (G=3, T=3), from the
same params and the same TokenPipeline batches.

The reference runs its Pallas kernels (impl="pallas", interpret mode);
the port runs the plain versions its CPU dispatch picks. Tolerance
(rtol 2e-4, atol 1e-6 on params and metrics): per-step gradients agree
to ~1e-6 relative (test_torch_model.py), and nine local steps with
three averagings carry that drift forward. adamw's params get atol 1e-5:
its step m/(sqrt(v)+eps) has size ~lr whatever |g| is, so on the few
weights whose gradient is near zero the two frameworks' last-bit
gradient differences move the step by up to ~1e-3 of lr (measured 6.8e-6
on 12 of 640k weights, against 9 steps x lr 3e-3 = 2.7e-2 of movement).
Wire-byte counts, step counts and the metric keys are exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs.base import get_config as jax_get_config
from repro.core import localsgd as jlsgd
from repro.data.synthetic import TokenPipeline as JaxTokenPipeline
from repro.models import build_model as jax_build_model
from repro.optim import packing as jpacking
from repro_torch import bridge, optim
from repro_torch.configs.base import get_config
from repro_torch.core import localsgd as lsgd
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.models.api import build_model
from repro_torch.optim import packing

G, T, ROUNDS, SEQ, PER_GROUP = 3, 3, 3, 16, 2
SMALL = dict(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256)
LR = {"sgd": 0.05, "momentum": 0.05, "adamw": 0.003}
TOL = dict(rtol=2e-4, atol=1e-6)
ADAMW_PARAMS_TOL = dict(rtol=2e-4, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_get_config("paper-mlp").reduced(), **SMALL)
    tcfg = dataclasses.replace(get_config("paper-mlp").reduced(), **SMALL)
    jmodel = jax_build_model(jcfg, schedule="rect")
    tmodel = build_model(tcfg, schedule="rect")
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(3)))
    jbatches = JaxTokenPipeline(jcfg.vocab_size, SEQ, seed=5).batches(
        (G, PER_GROUP))
    tbatches = TokenPipeline(tcfg.vocab_size, SEQ, seed=5).batches(
        (G, PER_GROUP))
    batches = []
    for _ in range(ROUNDS):
        jb, tb = next(jbatches)["tokens"], next(tbatches)["tokens"]
        assert tb.dtype == jb.dtype == np.int32
        np.testing.assert_array_equal(tb, jb)        # bit for bit
        batches.append(tb)
    return jmodel, tmodel, params, batches


def _run_reference(jmodel, params, batches, name, lcfg):
    opt = joptim.get(name, LR[name], packed=True, impl="pallas")
    layout = jpacking.layout_of(params)
    rnd = jax.jit(jlsgd.make_local_round(jmodel.loss, opt, lcfg,
                                         layout=layout))
    state = jlsgd.init_state(params, opt, n_groups=G, layout=layout)
    metrics = []
    for b in batches:
        state, m = rnd(state, {"tokens": jnp.asarray(b)})
        metrics.append(jax.device_get(m))
    return np.asarray(state["params"]), metrics


def _run_port(tmodel, params, batches, name, lcfg):
    opt = optim.get(name, LR[name], packed=True)
    tparams = bridge.params_from_numpy(params)
    layout = packing.layout_of(tparams)
    rnd = lsgd.make_local_round(tmodel.loss, opt, lcfg, layout=layout)
    state = lsgd.init_state(tparams, opt, G, layout)
    metrics = []
    for b in batches:
        state, m = rnd(state, {"tokens": torch.tensor(b)})
        metrics.append(m)
    return state, metrics


@pytest.mark.parametrize("name,metrics,t_i", [
    ("sgd", "final", None), ("sgd", "traj", None),
    ("momentum", "final", None), ("momentum", "traj", None),
    ("adamw", "final", None), ("adamw", "traj", None),
    ("adamw", "final", (1, 3, 2)),
])
def test_round_matches_reference(setup, name, metrics, t_i):
    jmodel, tmodel, params, batches = setup
    kw = dict(n_groups=G, inner_steps=T, t_i=t_i, metrics=metrics)
    jparams, jms = _run_reference(jmodel, params, batches, name,
                                  jlsgd.LocalSGDConfig(**kw))
    state, tms = _run_port(tmodel, params, batches, name,
                           lsgd.LocalSGDConfig(**kw))
    np.testing.assert_allclose(state["params"].numpy(), jparams,
                               **(ADAMW_PARAMS_TOL if name == "adamw" else TOL))
    for jm, tm in zip(jms, tms):
        assert set(tm) == set(jm)
        for k, jv in jm.items():
            tv = tm[k]
            if k.startswith("wire_bytes") or k == "inner_steps":
                np.testing.assert_array_equal(np.asarray(tv), np.asarray(jv))
            else:
                np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                           err_msg=k, **TOL)
    if t_i is not None:
        # adamw's per-group count advanced only on each group's own steps
        np.testing.assert_array_equal(state["opt"]["count"].numpy(),
                                      np.array(t_i) * ROUNDS)


def test_average_and_server_params():
    x = torch.tensor(np.random.RandomState(0).randn(4, 6).astype(np.float32))
    avg = lsgd.average_groups({"p": x})["p"]
    np.testing.assert_allclose(avg.numpy(),
                               np.broadcast_to(x.numpy().mean(0), (4, 6)),
                               rtol=1e-6)
    layout = packing.layout_of({"a": torch.zeros(2), "b": torch.zeros(2, 2)})
    srv = lsgd.server_params({"params": x}, layout)
    np.testing.assert_allclose(srv["b"].numpy().reshape(-1),
                               x.numpy().mean(0)[2:], rtol=1e-6)
