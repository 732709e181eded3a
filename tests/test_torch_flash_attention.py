"""The port's causal flash attention (its plain version, which the CPU
runs) against the reference's Pallas kernel in interpret mode and its
``flash_attention_ref``, on the same numpy inputs and the shapes of the
reference's own kernel test.

Tolerances: float32 rtol 1e-5 / atol 1e-6 against both (the oracle is
the same plain softmax summed in another order; the interpret kernel's
online softmax over blocks rounds differently again, within 6e-7 on
these shapes). bfloat16 at the reference test's tolerance, atol 2e-2 /
rtol 2e-1: inputs and the oracle's probabilities round to 8 bits."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import flash_attention as fa

SHAPES = [
    (1, 2, 128, 64, 128, 128),
    (2, 4, 256, 32, 128, 64),
    (1, 1, 512, 128, 128, 128),
    (1, 2, 256, 64, 64, 128),   # unequal q/k blocks
    (2, 1, 64, 16, 64, 64),     # single block
]
F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-1, atol=2e-2)


def _qkv(shape, seed=0, kv_heads=None):
    B, H, S, hd = shape
    rng = np.random.default_rng(seed)
    kv = (B, kv_heads or H, S, hd)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(kv).astype(np.float32),
            rng.standard_normal(kv).astype(np.float32))


@pytest.mark.parametrize("B,H,S,hd,bq,bk", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_reference_kernel_and_oracle(B, H, S, hd, bq, bk, dtype):
    q, k, v = _qkv((B, H, S, hd))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = fa.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                             block_q=bq, block_k=bk)
    assert got.dtype == tdt and got.shape == (B, H, S, hd)
    got = got.to(torch.float32).numpy()
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    oracle = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=True)
                        .astype(jnp.float32))
    kernel = np.asarray(jflash(jq, jk, jv, block_q=bq, block_k=bk,
                               interpret=True).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, oracle, **F32)
        np.testing.assert_allclose(got, kernel, **F32)
    else:
        np.testing.assert_allclose(got, oracle, **BF16)
        np.testing.assert_allclose(got, kernel, **BF16)


def test_gqa_reads_kv_head_h_over_g():
    """KV = 2 heads for H = 6: the same as the reference's path, which
    repeats each KV head g = 3 times before its kernel."""
    q, k, v = _qkv((2, 6, 128, 32), seed=1, kv_heads=2)
    got = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    want = jref.flash_attention_ref(jnp.asarray(q),
                                    jnp.repeat(jnp.asarray(k), 3, axis=1),
                                    jnp.repeat(jnp.asarray(v), 3, axis=1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_causality():
    """Perturbing the last kv position changes only the last query's
    output."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 1, 128, 32), seed=2))
    out1 = fa.flash_attention(q, k, v, block_q=64, block_k=64)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, -1] += 100.0
    v2[:, :, -1] += 100.0
    out2 = fa.flash_attention(q, k2, v2, block_q=64, block_k=64)
    assert torch.equal(out1[:, :, :-1], out2[:, :, :-1])
    assert not torch.allclose(out1[:, :, -1], out2[:, :, -1])


def test_refusals():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 192, 16)))
    with pytest.raises(ValueError, match="multiple of the blocks"):
        fa.flash_attention(q, k, v, block_q=128, block_k=128)
    q.requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fa.flash_attention(q, k, v, block_q=64, block_k=64)
    with pytest.raises(ValueError, match="impl='cuda'"):
        fa.flash_attention(q.detach(), k, v, block_q=64, block_k=64,
                           impl="cuda")
