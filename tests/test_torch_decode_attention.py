"""The port's paged decode attention (its plain version, which the CPU
runs) against the reference's ``paged_decode_attention_ref`` and its
Pallas kernel in interpret mode, on the same numpy inputs.

Tolerance: rtol 1e-5 / atol 1e-6. Both compute the same online softmax
over the same pages in float32; the reference forces each sum through
``dot_general`` and PyTorch's einsum sums in another order, so the
results differ in the last bits. The port's own invariances (garbage
past the length, the trash row) are exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jda
from repro_torch.kernels import decode_attention as da

TOL = dict(rtol=1e-5, atol=1e-6)


def _case(B, n_kv, g, hd, ps, nblk, seed=42):
    """The reference test's inputs: a random pool, permuted page tables,
    random queries and lengths in 1..ps*nblk."""
    rng = np.random.default_rng(seed)
    H = n_kv * g
    used = ps * n_kv * hd
    n_pages = 1 + 2 * B * nblk
    pool = rng.standard_normal(
        (n_pages, ((used + 255) // 256) * 256)).astype(np.float32)
    rows = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    rows_k = rows[:B * nblk].reshape(B, nblk)
    rows_v = rows[B * nblk:].reshape(B, nblk)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    lengths = rng.integers(1, ps * nblk + 1, size=B).astype(np.int32)
    return q, pool, rows_k, rows_v, lengths


def _port(q, pool, rows_k, rows_v, lengths, ps, n_kv, dtype=torch.float32):
    return da.paged_decode_attention(
        torch.from_numpy(q).to(dtype), torch.from_numpy(pool),
        torch.from_numpy(rows_k), torch.from_numpy(rows_v),
        torch.from_numpy(lengths), page_size=ps, n_kv=n_kv)


@pytest.mark.parametrize("B,n_kv,g,hd,ps,nblk", [
    (4, 2, 2, 8, 4, 5),      # GQA
    (3, 4, 1, 16, 8, 3),     # MHA
    (1, 1, 8, 32, 4, 2),     # MQA-ish, single row
    (5, 2, 4, 16, 4, 7),     # GQA, ragged lengths over many pages
])
def test_matches_reference_ref_and_interpret_kernel(B, n_kv, g, hd, ps, nblk):
    q, pool, rows_k, rows_v, lengths = _case(B, n_kv, g, hd, ps, nblk)
    got = _port(q, pool, rows_k, rows_v, lengths, ps, n_kv).numpy()
    args = tuple(jnp.asarray(a) for a in (q, pool, rows_k, rows_v, lengths))
    want_ref = np.asarray(jda.paged_decode_attention_ref(
        *args, page_size=ps, n_kv=n_kv))
    want_kernel = np.asarray(jda.paged_decode_attention(
        *args, page_size=ps, n_kv=n_kv, interpret=True))
    np.testing.assert_allclose(got, want_ref, **TOL)
    np.testing.assert_allclose(got, want_kernel, **TOL)


def test_bf16_queries_match_reference():
    q, pool, rows_k, rows_v, lengths = _case(4, 2, 2, 8, 4, 5, seed=3)
    got = _port(q, pool, rows_k, rows_v, lengths, 4, 2, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = jda.paged_decode_attention_ref(
        jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(pool),
        jnp.asarray(rows_k), jnp.asarray(rows_v), jnp.asarray(lengths),
        page_size=4, n_kv=2)
    # both round a float32 result to bfloat16: one bf16 step apart at most
    # where the float32 values straddle a rounding boundary, and a step
    # is at most 2**-7 of the value
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)


def test_garbage_past_the_length_never_leaks():
    """Pages and in-page positions at or past a slot's length (what the
    prefill's padding leaves in the pool) are poisoned with huge values:
    the output does not move by a bit."""
    ps, n_kv, hd = 4, 2, 8
    q, pool, rows_k, rows_v, _ = _case(3, n_kv, 2, hd, ps, 5, seed=7)
    lengths = np.array([6, 1, 13], np.int32)
    base = _port(q, pool, rows_k, rows_v, lengths, ps, n_kv)
    poisoned = pool.copy()
    used = ps * n_kv * hd
    for b, n in enumerate(lengths):
        for j in range(rows_k.shape[1]):
            for t in range(ps):
                if j * ps + t >= n:
                    for rows in (rows_k, rows_v):
                        poisoned[rows[b, j], t * n_kv * hd:
                                 (t + 1) * n_kv * hd] = 1e6
        poisoned[rows_k[b], used:] = np.nan       # row padding, never read
    got = _port(q, poisoned, rows_k, rows_v, lengths, ps, n_kv)
    assert torch.equal(got, base)


def test_trash_row_slots_are_finite_and_isolated():
    """Inactive slots point every table entry at trash row 0 with length
    1. They give finite garbage, and what the trash row holds never
    reaches an active slot (whose tables never contain row 0)."""
    ps, n_kv, hd = 4, 2, 8
    q, pool, rows_k, rows_v, lengths = _case(4, n_kv, 2, hd, ps, 5, seed=11)
    rows_k[[1, 3]] = 0
    rows_v[[1, 3]] = 0
    lengths[[1, 3]] = 1
    assert not (rows_k[[0, 2]] == 0).any() and not (rows_v[[0, 2]] == 0).any()
    a = _port(q, pool, rows_k, rows_v, lengths, ps, n_kv)
    assert bool(torch.isfinite(a).all())
    pool2 = pool.copy()
    pool2[0] = 1e6
    b = _port(q, pool2, rows_k, rows_v, lengths, ps, n_kv)
    assert torch.equal(a[[0, 2]], b[[0, 2]])
    want = np.asarray(jda.paged_decode_attention_ref(
        *(jnp.asarray(x) for x in (q, pool, rows_k, rows_v, lengths)),
        page_size=ps, n_kv=n_kv))
    np.testing.assert_allclose(a.numpy(), want, **TOL)


def test_refusals():
    q, pool, rows_k, rows_v, lengths = (torch.from_numpy(a) for a in
                                        _case(2, 2, 2, 8, 4, 3))
    kw = dict(page_size=4, n_kv=2)
    with pytest.raises(ValueError, match="impl='cuda'"):
        da.paged_decode_attention(q, pool, rows_k, rows_v, lengths,
                                  impl="cuda", **kw)
    with pytest.raises(ValueError, match="int32"):
        da.paged_decode_attention(q, pool, rows_k.long(), rows_v, lengths,
                                  **kw)
    with pytest.raises(ValueError, match="multiple"):
        da.paged_decode_attention(q, pool, rows_k, rows_v, lengths,
                                  page_size=4, n_kv=3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        da.paged_decode_attention(q.double(), pool, rows_k, rows_v, lengths,
                                  **kw)
