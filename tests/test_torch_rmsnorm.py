"""The port's ``rmsnorm`` through its CPU dispatch (the plain PyTorch
version) against the reference's Pallas kernel in interpret mode and its
jnp oracle, on the same numpy inputs.

Tolerances: float32 rtol 1e-6 / atol 1e-6 (the mean of squares is summed
in another order, and the two frameworks take rsqrt from different
libraries: a few ulp); bfloat16 within one bfloat16 step (rtol 2^-7),
since a last-bit difference in float32 may round the output to the
neighbouring bfloat16 value."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro_torch.kernels import ref, rmsnorm

SHAPES = [(4, 64), (2, 8, 128), (1, 31, 33), (300, 256), (1, 1, 1, 16)]
TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
       "bfloat16": dict(rtol=2.0 ** -7, atol=1e-6)}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(shape, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    w = (rs.randn(shape[-1]) + 1.0).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rmsnorm_matches_reference(shape, dtype):
    tdt, jdt = DTYPES[dtype]
    x, w = _inputs(shape)
    before = rmsnorm.launches
    got = rmsnorm.rmsnorm(torch.tensor(x).to(tdt), torch.tensor(w), eps=1e-5)
    assert rmsnorm.launches == before          # the plain version ran
    assert got.shape == shape and got.dtype == tdt
    jx = jnp.asarray(x).astype(jdt)
    pallas = jax_rmsnorm(jx, jnp.asarray(w), eps=1e-5, block_rows=64,
                         interpret=True)
    oracle = jref.rmsnorm_ref(jx, jnp.asarray(w), eps=1e-5)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **TOL[dtype])


def test_rmsnorm_block_rows_is_tiling_only():
    """The reference's block_rows changes nothing in the result; one below
    1 is refused, as the reference cannot tile by it."""
    x, w = _inputs((37, 48), seed=1)
    tx, tw = torch.tensor(x), torch.tensor(w)
    outs = [rmsnorm.rmsnorm(tx, tw, block_rows=b) for b in (1, 8, 128)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    with pytest.raises(ValueError, match="block_rows"):
        rmsnorm.rmsnorm(tx, tw, block_rows=0)


def test_rmsnorm_refuses_what_the_kernel_does_not_take():
    x, w = _inputs((4, 16))
    tx, tw = torch.tensor(x), torch.tensor(w)
    with pytest.raises(ValueError, match="impl='cuda'"):
        rmsnorm.rmsnorm(tx, tw, impl="cuda")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rmsnorm.rmsnorm(tx.double(), tw)
    with pytest.raises(ValueError, match="w must be"):
        rmsnorm.rmsnorm(tx, tw[:8])


def test_rmsnorm_eps_and_zero_rows():
    """An all-zero row normalises to zero (rsqrt(eps) is finite), and eps
    enters as the reference adds it."""
    x, w = _inputs((3, 32), seed=2)
    x[1] = 0.0
    for eps in (1e-5, 1e-2):
        got = ref.rmsnorm_ref(torch.tensor(x), torch.tensor(w), eps)
        want = jref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(w), eps=eps)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL["float32"])
        assert (got[1] == 0).all()
