"""The port's kernel entry point ``repro_torch.kernels.ops`` against the
reference's ``repro.kernels.ops`` (jitted, Pallas in interpret mode on
the CPU), function by function, on the same numpy inputs at small shapes.

Tolerances, per function, with their reasons (each kernel's own test
file says more): the optimizer updates rtol 1e-6 / atol 1e-7 (an ulp or
so of contraction and float32 ``pow``); the norms rtol 1e-5 (summation
order); rmsnorm rtol/atol 1e-6; attention rtol 1e-5 / atol 1e-6;
mamba_chunk the reference's 1e-4 (y, states) and 1e-5 (decay, cum);
dequantize bit-equal; quantize's scales within one ulp of the jitted
reference's (it multiplies by 1/127) and q equal where the scales are.
The reference's optimizer wrappers donate their buffers, so they get
copies; the port's update the flat buffers in place and return them."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops

EW = dict(rtol=1e-6, atol=1e-7)
NORM = dict(rtol=1e-5, atol=0.0)
ATTN = dict(rtol=1e-5, atol=1e-6)
FUNCTIONS = ["flash_attention", "paged_decode_attention", "rmsnorm",
             "fused_adamw", "fused_sgd", "fused_momentum", "sq_norm",
             "sq_norm_groups", "mamba_chunk", "quantize_int8",
             "dequantize_int8"]


def _randn(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _close(got, want, tol):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


def _decode_case():
    rng = np.random.default_rng(1)
    B, n_kv, g, hd, ps, nblk = 3, 2, 2, 8, 4, 5
    n_pages = 1 + 2 * B * nblk
    pool = rng.standard_normal((n_pages, 256)).astype(np.float32)
    rows = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    q = rng.standard_normal((B, n_kv * g, hd)).astype(np.float32)
    lengths = np.array([1, 7, 20], np.int32)
    return (q, pool, rows[:B * nblk].reshape(B, nblk),
            rows[B * nblk:].reshape(B, nblk), lengths), (ps, n_kv)


def case_flash_attention():
    q, k, v = (_randn(s, 1, 2, 128, 32) for s in range(3))
    _close(ops.flash_attention(*_t(q, k, v), 64, 64),
           jops.flash_attention(*_j(q, k, v), 64, 64), ATTN)


def case_paged_decode_attention():
    arrays, (ps, n_kv) = _decode_case()
    _close(ops.paged_decode_attention(*_t(*arrays), ps, n_kv),
           jops.paged_decode_attention(*_j(*arrays), ps, n_kv), ATTN)


def case_rmsnorm():
    x, w = _randn(0, 3, 5, 48), _randn(1, 48) + 1.0
    _close(ops.rmsnorm(*_t(x, w), 1e-5, 4), jops.rmsnorm(*_j(x, w), 1e-5, 4),
           dict(rtol=1e-6, atol=1e-6))


def case_fused_adamw():
    p, g = _randn(0, 1000), _randn(1, 1000)
    m, v = _randn(2, 1000, scale=0.1), np.abs(_randn(3, 1000, scale=0.01))
    bufs = _t(p, g, m, v)
    got = ops.fused_adamw(*bufs, 7, 1e-3, 0.9, 0.999, 1e-8, 0.01)
    assert all(a is b for a, b in zip(got, (bufs[0], bufs[2], bufs[3])))
    _close(got, jops.fused_adamw(*_j(p.copy(), g, m.copy(), v.copy()), 7,
                                 1e-3, 0.9, 0.999, 1e-8, 0.01), EW)


def case_fused_sgd():
    p, g = _randn(0, 1003), _randn(1, 1003)
    bufs = _t(p, g)
    got = ops.fused_sgd(*bufs, 0.1)
    assert got is bufs[0]
    _close(got, jops.fused_sgd(*_j(p.copy(), g), 0.1), EW)


def case_fused_momentum():
    p, g, mu = _randn(0, 1003), _randn(1, 1003), _randn(2, 1003, scale=0.1)
    bufs = _t(p, g, mu)
    got = ops.fused_momentum(*bufs, 0.1, 0.9)
    assert got[0] is bufs[0] and got[1] is bufs[2]
    _close(got, jops.fused_momentum(*_j(p.copy(), g, mu.copy()), 0.1, 0.9),
           EW)


def case_sq_norm():
    x = _randn(0, 70001)
    got = ops.sq_norm(*_t(x))
    assert got.shape == ()
    _close(got, jops.sq_norm(*_j(x)), NORM)


def case_sq_norm_groups():
    x = _randn(0, 3, 1003)
    _close(ops.sq_norm_groups(*_t(x)), jops.sq_norm_groups(*_j(x)), NORM)


def case_mamba_chunk():
    B, c, L, H, N, P = 1, 2, 16, 2, 8, 8
    xh, bm, cm = _randn(0, B, c, L, H, P), _randn(1, B, c, L, N), \
        _randn(2, B, c, L, N)
    dt = np.log1p(np.exp(_randn(3, B, c, L, H)))
    a = -np.abs(_randn(4, H)) - 0.1
    got = ops.mamba_chunk(*_t(xh, bm, cm, dt, a))
    want = jops.mamba_chunk(*_j(xh, bm, cm, dt, a))
    _close(got[:2], want[:2], dict(rtol=1e-4, atol=1e-4))
    _close(got[2:], want[2:], dict(rtol=1e-5, atol=1e-5))


def case_quantize_int8():
    x, u = _randn(0, 9, 37, scale=3.0), np.random.RandomState(1).rand(
        9, 37).astype(np.float32)
    x[4] = 0.0
    q, s = ops.quantize_int8(*_t(x, u))
    jq, js = (np.asarray(a) for a in jops.quantize_int8(*_j(x, u)))
    s = s.numpy()
    ulps = np.abs(s.view(np.int32).astype(np.int64)
                  - js.view(np.int32).astype(np.int64))
    assert (ulps <= 1).all()
    same = (s == js)[:, 0]
    np.testing.assert_array_equal(q.numpy()[same], jq[same])
    assert (np.abs(q.numpy()[~same].astype(int) - jq[~same]) <= 1).all()
    assert s[4, 0] == 1.0 and (q.numpy()[4] == 0).all()


def case_dequantize_int8():
    q = np.random.RandomState(0).randint(-127, 128, (9, 37)).astype(np.int8)
    scales = np.abs(_randn(1, 9, 1))
    got = ops.dequantize_int8(*_t(q, scales))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.dequantize_int8(*_j(q, scales))))


@pytest.mark.parametrize("name", FUNCTIONS)
def test_ops_match_the_reference_ops(name):
    globals()[f"case_{name}"]()


@pytest.mark.parametrize("name", FUNCTIONS)
def test_ops_have_the_reference_signature(name):
    """The reference's names and argument order (and defaults); the port
    adds only the keyword ``impl``."""
    want = inspect.signature(getattr(jops, name))
    got = inspect.signature(getattr(ops, name))
    params = [p for p in got.parameters.values() if p.name != "impl"]
    assert [(p.name, p.default) for p in params] == [
        (p.name, p.default) for p in want.parameters.values()]
    assert got.parameters["impl"].default == "auto"
    assert got.parameters["impl"].kind == inspect.Parameter.KEYWORD_ONLY


@pytest.mark.parametrize("module", [jops, ops])
def test_ops_are_the_reference_functions(module):
    """Both entry points define exactly the eleven functions."""
    public = {n for n, f in vars(module).items()
              if not n.startswith("_") and callable(f)
              and getattr(f, "__module__", "") == module.__name__}
    assert public == set(FUNCTIONS)


def test_impl_cuda_on_a_cpu_tensor_raises():
    x = torch.zeros(2, 64)
    flat = torch.zeros(64)
    arrays, (ps, n_kv) = _decode_case()
    calls = {
        "flash_attention": lambda: ops.flash_attention(
            *(torch.zeros(1, 1, 64, 16) for _ in range(3)), impl="cuda"),
        "paged_decode_attention": lambda: ops.paged_decode_attention(
            *_t(*arrays), ps, n_kv, impl="cuda"),
        "rmsnorm": lambda: ops.rmsnorm(x, torch.ones(64), impl="cuda"),
        "fused_adamw": lambda: ops.fused_adamw(
            flat, flat.clone(), flat.clone(), flat.clone(), 1, 1e-3,
            impl="cuda"),
        "fused_sgd": lambda: ops.fused_sgd(flat, flat.clone(), 0.1,
                                           impl="cuda"),
        "fused_momentum": lambda: ops.fused_momentum(
            flat, flat.clone(), flat.clone(), 0.1, impl="cuda"),
        "sq_norm": lambda: ops.sq_norm(flat, impl="cuda"),
        "sq_norm_groups": lambda: ops.sq_norm_groups(x, impl="cuda"),
        "mamba_chunk": lambda: ops.mamba_chunk(
            torch.zeros(1, 1, 8, 2, 4), torch.zeros(1, 1, 8, 4),
            torch.zeros(1, 1, 8, 4), torch.zeros(1, 1, 8, 2),
            torch.zeros(2), impl="cuda"),
        "quantize_int8": lambda: ops.quantize_int8(x, x.clone(), impl="cuda"),
        "dequantize_int8": lambda: ops.dequantize_int8(
            torch.zeros(2, 64, dtype=torch.int8), torch.ones(2, 1),
            impl="cuda"),
    }
    assert sorted(calls) == sorted(FUNCTIONS)
    for name, call in calls.items():
        with pytest.raises(ValueError, match="impl='cuda'"):
            call()


def test_optimizer_ops_take_flat_buffers_only():
    with pytest.raises(ValueError, match="flat 1-D"):
        ops.fused_sgd(torch.zeros(2, 8), torch.zeros(2, 8), 0.1)
