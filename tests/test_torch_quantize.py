"""The port's ``quantize_int8`` and ``dequantize_int8`` through their CPU
dispatch (the plain PyTorch versions) against the reference's Pallas
kernels in interpret mode and its eager jnp int8 codec, on the same numpy
inputs and numpy noise.

Tolerances, with their reasons:
- Against the eager jnp codec (``compress_rows`` of ``int8(impl="jnp")``,
  the same chain of IEEE operations) the composed pair is bit-equal, and
  so is it to the port's ``qdq_int8`` plain version.
- The reference's Pallas kernel runs under XLA's jit, which turns
  ``amax / 127`` into a product with 1/127: its scales may differ from
  the true quotient by one ulp (ROADMAP Queue C). Where a scale is equal,
  q is equal; where it differs, a q whose ``x/scale + u`` lies within the
  ulp of an integer may move by one step: those are allowed +-1 and
  counted, and must stay rare (at most 1% of such a row's elements).
- ``dequantize_int8`` is one product per element: bit-equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as jcodecs
from repro.kernels.quantize import dequantize_int8 as jax_dequantize
from repro.kernels.quantize import quantize_int8 as jax_quantize
from repro_torch.kernels import exchange_epilogue as ee
from repro_torch.kernels import quantize, ref

CHUNKS = [256, 128, 37]


def _case(rows, chunk, seed=0):
    """Rows of randn at a few scales, an all-zero row, a row zero in its
    first half, one large outlier, and noise u in [0, 1)."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(rows, chunk) * rs.choice([1e-3, 1.0, 50.0], (rows, 1))
         ).astype(np.float32)
    x[rows // 2] = 0.0
    x[1, : chunk // 2] = 0.0
    x[2, chunk // 3] = 400.0
    u = rs.rand(rows, chunk).astype(np.float32)
    return x, u


def _ulps_apart(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("rows", [1, 67])
def test_quantize_matches_reference(rows, chunk):
    x, u = _case(max(rows, 3), chunk)
    x, u = x[:rows], u[:rows]
    before = dict(quantize.launches)
    q, scales = quantize.quantize_int8(torch.tensor(x), torch.tensor(u))
    assert quantize.launches == before          # the plain version ran
    assert q.dtype == torch.int8 and q.shape == (rows, chunk)
    assert scales.dtype == torch.float32 and scales.shape == (rows, 1)
    q, scales = q.numpy(), scales.numpy()
    jq, js = jax_quantize(jnp.asarray(x), jnp.asarray(u), interpret=True)
    jq, js = np.asarray(jq), np.asarray(js)
    assert (_ulps_apart(scales, js) <= 1).all()
    same = (scales == js)[:, 0]
    np.testing.assert_array_equal(q[same], jq[same])
    moved = np.abs(q[~same].astype(np.int32) - jq[~same].astype(np.int32))
    assert (moved <= 1).all()
    assert moved.sum() <= 0.01 * max(moved.size, 1) + 1, (
        f"{int(moved.sum())} of {moved.size} q moved by one step")
    # all-zero rows quantize to 0 with scale 1
    zero = ~x.any(axis=1)
    assert (scales[zero] == 1.0).all() and (q[zero] == 0).all()
    assert (np.abs(q) <= 127).all()


@pytest.mark.parametrize("chunk", CHUNKS)
def test_pair_equals_qdq_int8_and_the_jnp_codec(chunk):
    """dequantize(quantize(x, u)) is the int8 codec's quantize+dequantize
    bit for bit: the port's qdq_int8 plain version, its wrapper, and the
    reference's eager jnp codec."""
    x, u = _case(67, chunk, seed=1)
    tx, tu = torch.tensor(x), torch.tensor(u)
    back = quantize.dequantize_int8(*quantize.quantize_int8(tx, tu)).numpy()
    np.testing.assert_array_equal(back, ref.qdq_int8_ref(tx, tu).numpy())
    np.testing.assert_array_equal(back, ee.qdq_int8(tx, tu).numpy())
    want = jcodecs.int8(chunk=chunk, impl="jnp").compress_rows(
        jnp.asarray(x), jnp.asarray(u))
    np.testing.assert_array_equal(back, np.asarray(want))


@pytest.mark.parametrize("chunk", CHUNKS)
def test_dequantize_matches_reference(chunk):
    rs = np.random.RandomState(2)
    q = rs.randint(-127, 128, (67, chunk)).astype(np.int8)
    scales = np.abs(rs.randn(67, 1)).astype(np.float32)
    scales[5] = 1.0
    got = quantize.dequantize_int8(torch.tensor(q), torch.tensor(scales))
    assert got.dtype == torch.float32 and got.shape == (67, chunk)
    want = jax_dequantize(jnp.asarray(q), jnp.asarray(scales),
                          interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(4, 16)
    with pytest.raises(ValueError, match="impl='cuda'"):
        quantize.quantize_int8(x, x.clone(), impl="cuda")
    with pytest.raises(ValueError, match="impl='cuda'"):
        quantize.dequantize_int8(torch.zeros(4, 16, dtype=torch.int8),
                                 torch.ones(4, 1), impl="cuda")
    with pytest.raises(TypeError, match="float32"):
        quantize.quantize_int8(x.double(), x.double())
    with pytest.raises(ValueError, match="shape"):
        quantize.quantize_int8(x, torch.zeros(4, 15))
    with pytest.raises(ValueError, match="shape"):
        quantize.dequantize_int8(torch.zeros(4, 16, dtype=torch.int8),
                                 torch.ones(4))
    with pytest.raises(ValueError, match="rows, chunk"):
        quantize.quantize_int8(x[0], x[0])
    with pytest.raises(ValueError, match="chunk >= 1"):
        quantize.quantize_int8(x[:, :0], x[:, :0])
