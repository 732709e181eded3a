"""The slice as a whole: the port's packed round with a lossy exchange
against the JAX round, over 3 rounds of a paper-mlp reduction, from the
same params and TokenPipeline batches, with the reference's int8 noise
fed into the port through the noise hook. The reference runs its
default (jnp) codecs under jit.

Tolerance. Per-step gradients differ between XLA and PyTorch by ~1e-6
relative (``test_torch_localsgd``), so each round's delta differs in its
last bits, and a quantized delta can round one step differently on a
few elements: int8 by one chunk quantum (amax/127 of the chunk), bf16
and fp16 by one step of the cast, top-k by swapping a near-tie at the
threshold. On ring and gossip the W product's last bits differ too,
which moves the next round's delta the same way. Such a step then stays
in the params (and, for adamw, moves later steps through m and v). So
params and moments are held at ``test_torch_localsgd``'s tolerance
(rtol 2e-4, atol 1e-6; adamw params atol 1e-5) on all but ``FLIP_FRAC``
of the elements (measured: 0.4% of gossip's fp16 ``mu`` after 3
rounds), and every element within ``FLIP_ATOL`` (a few quanta of these
rounds' deltas). Losses, grad norms and consensus use rtol 2e-3: the
consensus distance sums the squared deviations, to which a flipped
element adds up to a quantum. Wire bytes, step counts, codec counters
and the metric keys are exact.

adamw runs with eps 1e-3 where a lossy codec carries its moments. With
the default eps 1e-8 an element whose decoded v is 0 (int8z rounds it
there, or the clamp after an int8 downlink) while its m is not takes a
step of lr*m/eps, and this model's adamw diverges from round 1 on in
both packages alike (its consensus distance grows from ~6 to ~1e5);
past that point the two runs' last-bit differences grow without bound
and no tolerance compares them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.comm import codecs as jcodecs
from repro.comm import exchange as jexchange
from repro.configs.base import get_config as jax_get_config
from repro.core import localsgd as jlsgd
from repro.data.synthetic import TokenPipeline as JaxTokenPipeline
from repro.models import build_model as jax_build_model
from repro.optim import packing as jpacking
from repro_torch import bridge, comm, optim
from repro_torch.configs.base import get_config
from repro_torch.core import localsgd as lsgd
from repro_torch.models.api import build_model
from repro_torch.optim import packing

T, ROUNDS, SEQ, PER_GROUP, GMAX = 3, 3, 16, 2, 6
SMALL = dict(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256)
LR = {"sgd": 0.05, "momentum": 0.05, "adamw": 0.003}
TOL = dict(rtol=2e-4, atol=1e-6)
ADAMW_PARAMS_TOL = dict(rtol=2e-4, atol=1e-5)
METRIC_RTOL = 2e-3
FLIP_FRAC = 1e-2
FLIP_ATOL = 2e-3

# opt, topology, codec, moment codec, downlink codec, mix_rounds, G
CASES = {
    "server-int8-int8z-adamw": ("adamw", "server", "int8", "int8z", "", 1,
                                4),
    "ring-int8-mix2-sgd": ("sgd", "ring", "int8", "fp32", "", 2, 4),
    "server-topk-sgd": ("sgd", "server", "topk", "fp32", "", 1, 4),
    "gossip-bf16-fp16-momentum": ("momentum", "gossip", "bf16", "fp16", "",
                                  1, 6),
    "async-int8-sgd": ("sgd", "async_stale", "int8", "fp32", "", 1, 4),
    "fp32-int8-downlink-adamw": ("adamw", "server", "fp32", "fp32", "int8",
                                 1, 4),
}


def _hook(seed):
    ref = jcodecs.int8(seed=seed, impl="jnp")
    return lambda count, shape: np.asarray(ref.noise(count, shape))


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_get_config("paper-mlp").reduced(), **SMALL)
    tcfg = dataclasses.replace(get_config("paper-mlp").reduced(), **SMALL)
    jmodel = jax_build_model(jcfg, schedule="rect")
    tmodel = build_model(tcfg, schedule="rect")
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(3)))
    pipe = JaxTokenPipeline(jcfg.vocab_size, SEQ, seed=5).batches(
        (GMAX, PER_GROUP))
    batches = [next(pipe)["tokens"] for _ in range(ROUNDS)]
    return jmodel, tmodel, params, batches


def _assert_close_up_to_flips(got, want, tol, what):
    off = ~np.isclose(got, want, **tol)
    assert off.mean() <= FLIP_FRAC, f"{what}: {off.sum()} of {off.size} off"
    np.testing.assert_allclose(got, want, rtol=0, atol=FLIP_ATOL,
                               err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_lossy_round_matches_reference(setup, case):
    jmodel, tmodel, params, batches = setup
    name, topo, codec, mcodec, down, mix, G = CASES[case]
    kw = dict(moment_codec=mcodec, downlink_codec=down, mix_rounds=mix,
              staleness=1)
    lcfg = dict(n_groups=G, inner_steps=T, metrics="final")
    batches = [b[:G] for b in batches]

    okw = dict(eps=1e-3) if name == "adamw" else {}
    jopt = joptim.get(name, LR[name], packed=True, impl="jnp", **okw)
    jlayout = jpacking.layout_of(params)
    jex = jexchange.get_exchange(topo, codec, G, impl="jnp", **kw)
    jrnd = jax.jit(jlsgd.make_local_round(
        jmodel.loss, jopt, jlsgd.LocalSGDConfig(**lcfg), layout=jlayout,
        exchange=jex))
    jstate = jlsgd.init_state(params, jopt, n_groups=G, layout=jlayout,
                              exchange=jex)

    topt = optim.get(name, LR[name], packed=True, **okw)
    tparams = bridge.params_from_numpy(params)
    layout = packing.layout_of(tparams)
    tex = comm.get_exchange(topo, codec, G, noise_hook=_hook, **kw)
    trnd = lsgd.make_local_round(tmodel.loss, topt,
                                 lsgd.LocalSGDConfig(**lcfg), layout=layout,
                                 exchange=tex)
    tstate = lsgd.init_state(tparams, topt, G, layout, exchange=tex)
    assert set(tstate) == set(jstate)

    for b in batches:
        jstate, jm = jrnd(jstate, {"tokens": jnp.asarray(b)})
        tstate, tm = trnd(tstate, {"tokens": torch.tensor(b)})
        jm = jax.device_get(jm)
        assert set(tm) == set(jm)
        for k, jv in jm.items():
            if k.startswith("wire_bytes") or k == "inner_steps":
                np.testing.assert_array_equal(np.asarray(tm[k]),
                                              np.asarray(jv), err_msg=k)
            else:
                np.testing.assert_allclose(tm[k].numpy(), np.asarray(jv),
                                           rtol=METRIC_RTOL, atol=1e-6,
                                           err_msg=k)
    _assert_close_up_to_flips(
        tstate["params"].numpy(), np.asarray(jstate["params"]),
        ADAMW_PARAMS_TOL if name == "adamw" else TOL, "params")
    for k in topt.moment_keys:
        _assert_close_up_to_flips(tstate["opt"][k].numpy(),
                                  np.asarray(jstate["opt"][k]), TOL, k)
    for s, st in tstate.get("comm", {}).get("codec", {}).items():
        if "count" in st:
            assert int(st["count"]) == int(jstate["comm"]["codec"][s]["count"])
    assert bool(torch.isfinite(tstate["params"]).all())
