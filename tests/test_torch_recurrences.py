"""The port's recurrent blocks (``models/mamba.py``, ``models/xlstm.py``)
against the reference's on the same params (``init_params`` from a
PRNGKey, at the zamba2-7b and xlstm-1.3b reductions), and the
reference's recurrence properties held on the port: mamba chunked =
recurrent, mLSTM chunked = recurrent, sLSTM scan = stepwise.

Also the one place the port departs from the reference: at the configs'
chunk of 128 the reference's masked decay exp(cum_i - cum_j) overflows
above the diagonal and its gradient there is 0 * inf = NaN; the port
masks before the exp, which gives the same forward values and a finite
gradient, equal to the reference's at a chunk where it is finite (the
chunked forms are the same function for every chunk size).

Tolerance: port against reference rtol 1e-5 / atol 1e-5 (forward,
float32; products summed in another order), decode steps and caches
the same; the chunked-vs-recurrent properties at the reference tests'
bounds (atol 5e-4 / rtol 5e-3 for mamba and mLSTM, atol 1e-4 / rtol
1e-3 for sLSTM); the port's chunk-128 gradient against the reference's
at chunk 8 rtol 1e-3 / atol 1e-5 (the same sums in two orders, through
128 steps of decay)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import mamba as jmam
from repro.models import xlstm as jxl
from repro.models.layers import init_params
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.models import mamba, xlstm

TOL = dict(rtol=1e-5, atol=1e-5)
# one gradient through two chunk sizes: the same sums in two orders
CHUNK_GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
BLOCKS = {
    "mamba": ("zamba2-7b", jmam.mamba_defs, jmam.mamba_forward,
              mamba.mamba_forward, jmam.mamba_decode, mamba.mamba_decode,
              jmam.init_mamba_cache, mamba.init_mamba_cache),
    "mlstm": ("xlstm-1.3b", jxl.mlstm_defs, jxl.mlstm_forward,
              xlstm.mlstm_forward, jxl.mlstm_decode, xlstm.mlstm_decode,
              jxl.init_mlstm_cache, xlstm.init_mlstm_cache),
    "slstm": ("xlstm-1.3b", jxl.slstm_defs, jxl.slstm_forward,
              xlstm.slstm_forward, jxl.slstm_decode, xlstm.slstm_decode,
              jxl.init_slstm_cache, xlstm.init_slstm_cache),
}


def _setup(block, B=2, S=16, seed=0, **changes):
    arch, defs = BLOCKS[block][:2]
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **changes)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    p = jax.device_get(init_params(defs(jcfg), jax.random.PRNGKey(seed)))
    x = (np.random.RandomState(seed + 1).randn(B, S, jcfg.d_model) * 0.5
         ).astype(np.float32)
    return jcfg, tcfg, p, bridge.params_from_numpy(p), x


@pytest.mark.parametrize("block", sorted(BLOCKS))
@pytest.mark.parametrize("chunk", [4, 8])
def test_forward_equals_reference(block, chunk):
    jfwd, tfwd = BLOCKS[block][2:4]
    jcfg, tcfg, p, tp, x = _setup(block, chunk_size=chunk)
    want = jfwd(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    got = tfwd(tp, torch.tensor(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_decode_steps_and_cache_equal_reference(block):
    jdec, tdec, jinit, tinit = BLOCKS[block][4:]
    jcfg, tcfg, p, tp, x = _setup(block, B=3, S=5)
    jp = jax.tree.map(jnp.asarray, p)
    jc = jinit(jcfg, 3, jnp.float32)
    tc = tinit(tcfg, 3, torch.float32)
    for t in range(x.shape[1]):
        jy, jc = jdec(jp, jnp.asarray(x[:, t:t + 1]), jcfg, jc)
        ty, tc = tdec(tp, torch.tensor(x[:, t:t + 1]), tcfg, tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert sorted(tc) == sorted(jc)
    for k in tc:
        assert tc[k].dtype == torch.float32 and tc[k].shape == jc[k].shape
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)


RECURRENT_TOL = {"mamba": dict(atol=5e-4, rtol=5e-3),
                 "mlstm": dict(atol=5e-4, rtol=5e-3),
                 "slstm": dict(atol=1e-4, rtol=1e-3)}


@pytest.mark.parametrize("block,chunk", [("mamba", 4), ("mamba", 8),
                                         ("mlstm", 4), ("mlstm", 8),
                                         ("slstm", 8)])
def test_chunked_equals_recurrent(block, chunk):
    """The reference's recurrence properties, on the port: the parallel
    forward over 16 (sLSTM 12) tokens equals feeding them one at a time
    through the decode step."""
    tfwd, tdec, tinit = BLOCKS[block][3], BLOCKS[block][5], BLOCKS[block][7]
    S = 12 if block == "slstm" else 16
    _, cfg, _, tp, x = _setup(block, S=S, chunk_size=chunk, seed=3)
    x = torch.tensor(x)
    y_par = tfwd(tp, x, cfg)
    cache = tinit(cfg, 2, torch.float32)
    ys = []
    for t in range(S):
        y, cache = tdec(tp, x[:, t:t + 1], cfg, cache)
        ys.append(y)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(ys, 1).numpy(),
                               **RECURRENT_TOL[block])


def _grads(fwd, params, x, cfg):
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    fwd(params, x, cfg).square().sum().backward()
    return {k: v.grad for k, v in params.items()}


@pytest.mark.parametrize("block", ["mamba", "mlstm"])
def test_chunk_128_gradient_is_finite_where_the_reference_nans(block):
    """One chunk of 128 (the configs' chunk_size). The reference's
    gradient has NaN in the decay's parameters (mamba: a_log, dt_bias,
    w_dt; mLSTM: the gate weights w_if, b_if); the port's forward equals
    the reference's, and its gradient is finite and equals the
    reference's at chunk 8, where the reference's is finite."""
    jfwd, tfwd = BLOCKS[block][2:4]
    jcfg, tcfg, p, tp, x = _setup(block, B=1, S=128, chunk_size=128)
    jp = jax.tree.map(jnp.asarray, p)

    def jgrad(cfg):
        return jax.jit(jax.grad(
            lambda q: jnp.sum(jfwd(q, jnp.asarray(x), cfg) ** 2)))(jp)

    jg = jgrad(jcfg)
    nan = sorted(k for k, v in jg.items() if not np.isfinite(v).all())
    assert nan == (["a_log", "dt_bias", "w_dt"] if block == "mamba"
                   else ["b_if", "w_if"])
    np.testing.assert_allclose(
        tfwd(tp, torch.tensor(x), tcfg).numpy(),
        np.asarray(jfwd(jp, jnp.asarray(x), jcfg)), **TOL)
    got = _grads(tfwd, tp, torch.tensor(x), tcfg)
    want = jgrad(dataclasses.replace(jcfg, chunk_size=8))
    for k, g in got.items():
        assert bool(torch.isfinite(g).all()), k
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   err_msg=k, **CHUNK_GRAD_TOL)
