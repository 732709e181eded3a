"""The port's ``mamba_chunk`` through its CPU dispatch (the plain PyTorch
version) against the reference's Pallas kernel in interpret mode and its
single-chunk jnp oracle, on the same numpy inputs.

Tolerances are the reference's own (``tests/test_kernels.py``): y and
the states rtol/atol 1e-4 (the products sum in another order), the
chunk decay and cum rtol/atol 1e-5 (the port sums cum in sequence, XLA
in its own order). bfloat16 xh: y within one bfloat16 step of the
reference's, computed from the same bfloat16 inputs. No output may hold
a NaN: with a large |a| the decay above the diagonal overflows, and it
must be selected away, never multiplied by a mask."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mamba_scan import mamba_chunk as jax_mamba_chunk
from repro_torch.kernels import mamba_scan

SHAPES = [(1, 1, 8, 2, 4, 4), (2, 3, 16, 2, 8, 8), (1, 2, 128, 4, 64, 64),
          (1, 2, 96, 3, 16, 8)]           # B, c, L, H, N, P
YS = dict(rtol=1e-4, atol=1e-4)
CUM = dict(rtol=1e-5, atol=1e-5)


def _softplus(v):
    return np.log1p(np.exp(v))


def _inputs(B, c, L, H, N, P, seed=0, a=None, dt=None):
    rs = np.random.RandomState(seed)
    xh = rs.randn(B, c, L, H, P).astype(np.float32)
    bm = rs.randn(B, c, L, N).astype(np.float32)
    cm = rs.randn(B, c, L, N).astype(np.float32)
    dtv = _softplus(rs.randn(B, c, L, H)).astype(np.float32) \
        if dt is None else np.full((B, c, L, H), dt, np.float32)
    av = (-np.abs(rs.randn(H)) - 0.1).astype(np.float32) \
        if a is None else np.full((H,), a, np.float32)
    return xh, bm, cm, dtv, av


def _port(arrays, dtype=torch.float32):
    xh, *rest = (torch.tensor(t) for t in arrays)
    return mamba_scan.mamba_chunk(xh.to(dtype), *rest)


def _check(got, want, ys=YS):
    y, st, dec, cum = (g.float().numpy() for g in got)
    for g in (y, st, dec, cum):
        assert np.isfinite(g).all()
    jy, jst, jdec, jcum = (np.asarray(w, np.float32) for w in want)
    np.testing.assert_allclose(y, jy, **ys)
    np.testing.assert_allclose(st, jst, **YS)
    np.testing.assert_allclose(dec, jdec, **CUM)
    np.testing.assert_allclose(cum, jcum, **CUM)


@pytest.mark.parametrize("B,c,L,H,N,P", SHAPES)
def test_mamba_chunk_matches_reference(B, c, L, H, N, P):
    arrays = _inputs(B, c, L, H, N, P)
    before = mamba_scan.launches
    got = _port(arrays)
    assert mamba_scan.launches == before        # the plain version ran
    assert [tuple(g.shape) for g in got] == [
        (B, c, L, H, P), (B, c, H, N, P), (B, c, H), (B, c, L, H)]
    assert all(g.dtype == torch.float32 for g in got)
    want = jax_mamba_chunk(*(jnp.asarray(t) for t in arrays), interpret=True)
    _check(got, want)
    # the single-chunk oracle, one chunk at a time
    xh, bm, cm, dt, a = (jnp.asarray(t) for t in arrays)
    for b in range(B):
        for ci in range(c):
            one = jref.mamba_chunk_ref(xh[b, ci], bm[b, ci], cm[b, ci],
                                       dt[b, ci], a)
            _check([g[b, ci] for g in got], one)


def test_mamba_chunk_large_decay_has_no_nan():
    """a = -50 and dt = softplus(3): cum falls by ~150 a step, so
    exp(cum_i - cum_j) above the diagonal is inf; the outputs stay
    finite and equal the reference's."""
    arrays = _inputs(1, 2, 16, 2, 8, 8, seed=3, a=-50.0,
                     dt=float(_softplus(3.0)))
    got = _port(arrays)
    want = jax_mamba_chunk(*(jnp.asarray(t) for t in arrays), interpret=True)
    _check(got, want)
    assert float(got[2].abs().max()) == 0.0     # exp(cum_last) underflows


def test_mamba_chunk_bfloat16_xh():
    """xh in bfloat16: y comes back in bfloat16, the rest in float32,
    from the same bfloat16 values the reference reads."""
    arrays = _inputs(1, 2, 32, 2, 8, 16, seed=4)
    got = _port(arrays, torch.bfloat16)
    assert got[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got[1:])
    xb = jnp.asarray(arrays[0]).astype(jnp.bfloat16)
    want = jax_mamba_chunk(xb, *(jnp.asarray(t) for t in arrays[1:]),
                           interpret=True)
    assert want[0].dtype == jnp.bfloat16
    _check(got, want, ys=dict(rtol=2.0 ** -7, atol=1e-4))


def test_mamba_chunk_is_forward_only_and_checks_its_inputs():
    xh, bm, cm, dt, a = (torch.tensor(t) for t in _inputs(1, 1, 8, 2, 4, 4))
    with pytest.raises(NotImplementedError, match="forward only"):
        mamba_scan.mamba_chunk(xh.requires_grad_(), bm, cm, dt, a)
    xh = xh.detach()
    with torch.no_grad():
        mamba_scan.mamba_chunk(xh.requires_grad_(), bm, cm, dt, a)
    xh = xh.detach()
    with pytest.raises(ValueError, match="impl='cuda'"):
        mamba_scan.mamba_chunk(xh, bm, cm, dt, a, impl="cuda")
    with pytest.raises(ValueError, match="dt must be"):
        mamba_scan.mamba_chunk(xh, bm, cm, dt[..., :1], a)
    with pytest.raises(ValueError, match="xh must be"):
        mamba_scan.mamba_chunk(xh[0], bm, cm, dt, a)
    with pytest.raises(ValueError, match="at least one step"):
        mamba_scan.mamba_chunk(xh[:, :, :0], bm[:, :, :0], cm[:, :, :0],
                               dt[:, :, :0], a)


def test_shared_memory_of_the_kernel():
    """zamba2-7b's tile (L 128, N 64, P 64) fits two blocks an SM, in
    float32 and bfloat16; the wrapper finds a tile too large for one block
    (and refuses it on the card) by the kernel's own count, and refuses a
    chunk longer than the kernel's 8 row tiles of 16."""
    assert mamba_scan.smem_bytes(128, 64, 64) == 114_960
    assert mamba_scan.smem_bytes(128, 64, 64, 2) <= 114_960
    assert 2 * (mamba_scan.smem_bytes(128, 64, 64) + 1024) <= 228 * 1024
    assert mamba_scan.smem_bytes(256, 128, 128) > mamba_scan.MAX_SMEM
    assert mamba_scan.smem_bytes(128, 128, 128) <= mamba_scan.MAX_SMEM
    assert mamba_scan.MAX_CHUNK == 128
