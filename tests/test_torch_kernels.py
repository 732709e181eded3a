"""The port's four kernels, through their CPU dispatch (the plain PyTorch
versions), against the reference's Pallas kernels in interpret mode and
against ``repro.kernels.ref``, on the same numpy inputs.

Tolerances: the elementwise updates use rtol 1e-6 / atol 1e-7 (the
chip-side tolerance; the two frameworks may contract a multiply-add or
take float32 ``pow`` from different libraries, an ulp or so). The norm
uses rtol 1e-5 (summation order differs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.fused_adamw import fused_adamw as jax_adamw
from repro.kernels.fused_momentum import fused_momentum as jax_momentum
from repro.kernels.fused_sgd import fused_sgd as jax_sgd
from repro.kernels.sq_norm import sq_norm_groups as jax_sq_norm_groups
from repro_torch import kernels
from repro_torch.kernels import build, fused_adamw, fused_momentum, fused_sgd
from repro_torch.kernels import sq_norm

EW = dict(rtol=1e-6, atol=1e-7)
SHAPES = [(1, 8), (3, 1003), (1, 70001)]


def _rand(seed, shape, scale=1.0, positive=False):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return np.abs(x) if positive else x


def _jax_rows(fn, *bufs, **kw):
    """Run a flat reference kernel over (G, N) buffers, as the packed
    optimizers do (``_raveled``), in interpret mode."""
    G, N = bufs[0].shape
    out = fn(*(jnp.asarray(b.reshape(-1)) for b in bufs), block=4096,
             interpret=True, **kw)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [np.asarray(o).reshape(G, N) for o in outs]


@pytest.mark.parametrize("G,N", SHAPES)
def test_sgd_matches_reference(G, N):
    p, g = _rand(0, (G, N)), _rand(1, (G, N))
    got = torch.tensor(p)
    before = fused_sgd.launches
    fused_sgd.fused_sgd(got, torch.tensor(g), lr=0.1)
    assert fused_sgd.launches == before       # the plain version ran
    want, = _jax_rows(lambda p, g, **kw: jax_sgd(p, g, lr=0.1, **kw), p, g)
    np.testing.assert_allclose(got.numpy(), want, **EW)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.sgd_ref(jnp.asarray(p), jnp.asarray(g),
                                             lr=0.1)), **EW)


@pytest.mark.parametrize("G,N", SHAPES)
@pytest.mark.parametrize("beta", [0.0, 0.9])
def test_momentum_matches_reference(G, N, beta):
    p, g, mu = _rand(0, (G, N)), _rand(1, (G, N)), _rand(2, (G, N), 0.1)
    tp, tmu = torch.tensor(p), torch.tensor(mu)
    fused_momentum.fused_momentum(tp, torch.tensor(g), tmu, lr=0.1, beta=beta)
    want = _jax_rows(lambda p, g, mu, **kw: jax_momentum(
        p, g, mu, lr=0.1, beta=beta, **kw), p, g, mu)
    oracle = jref.momentum_ref(jnp.asarray(p), jnp.asarray(g),
                               jnp.asarray(mu), lr=0.1, beta=beta)
    for a, b, c in zip((tp, tmu), want, oracle):
        np.testing.assert_allclose(a.numpy(), b, **EW)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), **EW)


@pytest.mark.parametrize("G,N", [(1, 1003), (3, 70001)])
@pytest.mark.parametrize("count", [1, 10, 1000])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adamw_matches_reference(G, N, count, wd):
    p, g = _rand(0, (G, N)), _rand(1, (G, N))
    m, v = _rand(2, (G, N), 0.1), _rand(3, (G, N), 0.01, positive=True)
    tp, tm, tv = torch.tensor(p), torch.tensor(m), torch.tensor(v)
    fused_adamw.fused_adamw(tp, torch.tensor(g), tm, tv,
                            torch.tensor(count, dtype=torch.int32),
                            lr=1e-3, wd=wd)
    want = _jax_rows(lambda p, g, m, v, **kw: jax_adamw(
        p, g, m, v, count=count, lr=1e-3, wd=wd, **kw), p, g, m, v)
    oracle = jref.adamw_ref(*(jnp.asarray(x) for x in (p, g, m, v)),
                            count=count, lr=1e-3, wd=wd)
    for a, b, c in zip((tp, tm, tv), want, oracle):
        np.testing.assert_allclose(a.numpy(), b, **EW)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), **EW)


def test_adamw_per_row_count_and_active_mask():
    """One count per row (the t_i schedule's per-group counts) and a row
    switched off: active rows follow the reference at their own count,
    the inactive row keeps p, m and v bit for bit."""
    G, N, counts = 3, 1003, (1, 10, 1000)
    p, g = _rand(0, (G, N)), _rand(1, (G, N))
    m, v = _rand(2, (G, N), 0.1), _rand(3, (G, N), 0.01, positive=True)
    tp, tm, tv = torch.tensor(p), torch.tensor(m), torch.tensor(v)
    fused_adamw.fused_adamw(tp, torch.tensor(g), tm, tv,
                            torch.tensor(counts, dtype=torch.int32),
                            lr=1e-3, wd=0.01,
                            active=torch.tensor([True, False, True]))
    for r in (0, 2):
        want = jax_adamw(*(jnp.asarray(x[r]) for x in (p, g, m, v)),
                         count=counts[r], lr=1e-3, wd=0.01, block=4096,
                         interpret=True)
        for a, b in zip((tp, tm, tv), want):
            np.testing.assert_allclose(a[r].numpy(), np.asarray(b), **EW)
    for a, b in zip((tp, tm, tv), (p, m, v)):
        np.testing.assert_array_equal(a[1].numpy(), b[1])


@pytest.mark.parametrize("which", ["sgd", "momentum"])
def test_active_mask_leaves_rows_untouched(which):
    G, N = 3, 1003
    p, g, mu = _rand(0, (G, N)), _rand(1, (G, N)), _rand(2, (G, N), 0.1)
    tp, tmu = torch.tensor(p), torch.tensor(mu)
    active = torch.tensor([False, True, False])
    if which == "sgd":
        fused_sgd.fused_sgd(tp, torch.tensor(g), lr=0.1, active=active)
        want = [np.asarray(jref.sgd_ref(jnp.asarray(p), jnp.asarray(g),
                                        lr=0.1))]
        got, old = [tp], [p]
    else:
        fused_momentum.fused_momentum(tp, torch.tensor(g), tmu, lr=0.1,
                                      active=active)
        want = [np.asarray(x) for x in jref.momentum_ref(
            jnp.asarray(p), jnp.asarray(g), jnp.asarray(mu), lr=0.1)]
        got, old = [tp, tmu], [p, mu]
    for a, b, o in zip(got, want, old):
        np.testing.assert_allclose(a[1].numpy(), b[1], **EW)
        np.testing.assert_array_equal(a[[0, 2]].numpy(), o[[0, 2]])


@pytest.mark.parametrize("G,N", [(1, 64), (3, 1003), (4, 70001)])
def test_sq_norm_groups_matches_reference(G, N):
    x = _rand(0, (G, N))
    got = sq_norm.sq_norm_groups(torch.tensor(x)).numpy()
    want = np.asarray(jax_sq_norm_groups(jnp.asarray(x), block=4096,
                                         interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jnp.sum(jnp.square(jnp.asarray(x)), axis=-1)),
        rtol=1e-5)


def test_dispatch_rules():
    cpu = torch.device("cpu")
    assert kernels.resolve_impl("auto", cpu) == "torch"
    assert kernels.resolve_impl("torch", cpu) == "torch"
    assert kernels.resolve_impl("auto", torch.device("cuda", 0)) == "cuda"
    assert kernels.resolve_impl("torch", torch.device("cuda", 0)) == "torch"
    with pytest.raises(ValueError, match="impl='cuda'"):
        kernels.resolve_impl("cuda", cpu)
    with pytest.raises(ValueError, match="unknown impl"):
        kernels.resolve_impl("pallas", cpu)
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="impl='cuda'"):
        fused_sgd.fused_sgd(x, x.clone(), lr=0.1, impl="cuda")
    with pytest.raises(ValueError, match="impl='cuda'"):
        sq_norm.sq_norm_groups(x, impl="cuda")
    with pytest.raises(TypeError, match="float32"):
        fused_sgd.fused_sgd(x.double(), x.double(), lr=0.1)
    with pytest.raises(ValueError, match="shape"):
        fused_sgd.fused_sgd(x, torch.zeros(2, 9), lr=0.1)
    with pytest.raises(ValueError, match="active"):
        fused_sgd.fused_sgd(x, x.clone(), lr=0.1, active=torch.ones(3).bool())


def test_kernels_build_for_hopper_from_the_sources_alone():
    """Importing the kernel modules builds nothing; the build targets
    sm_90a with IEEE math, and every launcher has a source under csrc/."""
    assert not build._libs
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags
    for stem, fns in build.SIGNATURES.items():
        src = (build.CSRC / f"{stem}.cu").read_text()
        for name in fns:
            assert f'extern "C" int {name}(' in src
    assert build.library_path("sq_norm").parent == build.BUILD_DIR
