"""The vlm and audio families in the port against the reference:
internvl2-1b (a projector on the stubbed ViT's patch embeddings, which
take the first ``n_patches`` token slots, then the qwen2 decoder) and
whisper-base (a projector on the stubbed conv frontend's frame
embeddings, a non-causal encoder without RoPE, decoder layers of self
attention, cross attention and a GELU mlp). On their reductions (2
layers, d 256, float32) with the reference's params from ``PRNGKey(0)``
and patches and frames from a numpy seed: the configs field for field,
``forward``, whisper's ``encode``, the loss and the flat gradient, the
non-causal and cross ``attention_forward`` and the cross-attention
decode helpers, the launchers' modality inputs, the params through the
checkpoint format and the bridge, and packed and pytree local-SGD rounds
(sgd and adamw) against the reference's.

Tolerance: forward, encode, loss and attention rtol 1e-5 / atol 1e-5;
the flat gradient rtol 1e-4 / atol 1e-6; the rounds within
``test_torch_families.py``'s ``ROUND_TOL`` and, for adamw's params,
``ADAMW_PARAMS_TOL`` on all but ``ADAMW_STRAY`` of the elements (the
near-zero-gradient effect that file describes: adamw turns last-bit
differences of a gradient near 0 into steps of up to ~lr). Whisper has
more such elements than the families: the key biases' gradient is 0
exactly (a shift every score of a query shares, which the softmax
drops), so it is float32 noise, and 241 of the 512 key-bias elements
of the whisper reduction stray after two rounds; with the other near-0
gradients, 774 of 5,648,896 elements (1.4e-4; internvl2 stays under
1e-4). ``ADAMW_STRAY`` is 5e-4 here for that reason. The modality
inputs and the checkpoint round trip are exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.checkpoint import io as jckpt
from repro.configs import base as jbase
from repro.core import localsgd as jlsgd
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.optim import packing as jpacking
from repro_torch import bridge, optim, tree
from repro_torch.checkpoint import io as ckpt
from repro_torch.configs import base
from repro_torch.core import localsgd as lsgd
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.launch import train
from repro_torch.models import attention as attn
from repro_torch.models.api import build_model
from repro_torch.optim import packing

ARCHS = ("internvl2-1b", "whisper-base")
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
ROUND_TOL = dict(rtol=2e-4, atol=1e-6)
ADAMW_PARAMS_TOL = dict(rtol=2e-4, atol=1e-5)
ADAMW_STRAY = 5e-4          # see the module docstring
SEQ = 16
ROUNDS, G, T, PER_GROUP = 2, 2, 2, 2
LR = {"sgd": 0.05, "adamw": 0.003}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the port's side: its many small ops stall
    for a scheduler slice each when the machine is loaded, as under the
    parallel suite (ROADMAP.md, ground rules: tests)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=ARCHS)
def both(request):
    """(reference model, port model, the reference's params as numpy,
    a batch of 2 x SEQ tokens with the launchers' modality inputs)."""
    jcfg = jbase.get_config(request.param).reduced()
    jmodel = jbuild_model(jcfg, schedule="rect")
    tmodel = build_model(base.get_config(request.param).reduced(),
                         schedule="rect")
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    tokens = np.random.RandomState(1).randint(
        0, jcfg.vocab_size, size=(2, SEQ)).astype(np.int32)
    batch = jtrain.add_modalities({"tokens": tokens}, jcfg,
                                  np.random.RandomState(2))
    return jmodel, tmodel, params, jax.device_get(batch)


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    got, want = base.get_config(arch), jbase.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())
    assert (got.padded_vocab, got.resolved_head_dim) == \
        (want.padded_vocab, want.resolved_head_dim)


def test_forward_encode_and_loss_match_reference(both):
    jmodel, tmodel, params, batch = both
    tparams = bridge.params_from_numpy(params)
    assert [tuple(t.shape) for t in tree.leaves(tparams)] == \
        [tuple(t.shape) for t in tree.leaves(tmodel.abstract())]
    jx, jaux = jmodel.forward(params, _j(batch))
    tx, taux = tmodel.forward(tparams, _t(batch))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **FWD_TOL)
    assert taux.item() == float(jaux) == 0.0
    np.testing.assert_allclose(tmodel.loss(tparams, _t(batch)).item(),
                               float(jmodel.loss(params, _j(batch))),
                               **FWD_TOL)
    if tmodel.cfg.family == "audio":
        np.testing.assert_allclose(
            tmodel.encode(tparams, _t(batch)["frames"]).numpy(),
            np.asarray(jmodel.encode(params, jnp.asarray(batch["frames"]))),
            **FWD_TOL)
    else:
        # the patches replace the first n_patches token slots: without
        # them the vlm is its text decoder
        text = {"tokens": batch["tokens"]}
        tt = tmodel.forward(tparams, _t(text))[0].numpy()
        np.testing.assert_allclose(
            tt, np.asarray(jmodel.forward(params, _j(text))[0]), **FWD_TOL)
        assert not np.allclose(tt, tx.numpy(), **FWD_TOL)


def test_flat_gradient_matches_reference(both):
    jmodel, tmodel, params, batch = both
    jl = jpacking.layout_of(params)
    jloss, jgrad = jax.jit(jpacking.value_and_flat_grad(jmodel.loss, jl))(
        jpacking.pack(params, jl), _j(batch))
    tparams = bridge.params_from_numpy(params)
    tl = packing.layout_of(tparams)
    assert (tl.offsets, tl.sizes, tl.shapes) == (jl.offsets, jl.sizes,
                                                 jl.shapes)
    tloss, tgrad = packing.value_and_flat_grad(tmodel.loss, tl)(
        packing.pack(tparams, tl), _t(batch))
    np.testing.assert_allclose(tloss.item(), float(jloss), **FWD_TOL)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), **GRAD_TOL)
    # every leaf has a gradient: the projector through the patches or
    # frames, whisper's encoder through the cross attention
    for path, off, size in zip(tl.paths, tl.offsets, tl.sizes):
        if path[-1] not in ("b", "bq", "bk", "bv"):
            assert float(tgrad[off:off + size].abs().sum()) > 0, path


def test_attention_noncausal_and_cross_match_reference():
    """``attention_forward`` off its causal self-attention branch: the
    encoder's non-causal self attention without RoPE, cross attention
    over a longer and a shorter x_kv, causal cross attention (the mask
    offset by Sk - S) with RoPE at given positions; then the
    cross-attention cache and its one-token decode."""
    jcfg = jbase.get_config("whisper-base").reduced()
    cfg = base.get_config("whisper-base").reduced()
    jp = jax.device_get(jbuild_model(jcfg).init(jax.random.PRNGKey(0)))
    jp = jax.tree.map(lambda a: a[1], jp["dec"]["cross_attn"])
    tp = bridge.params_from_numpy(jp)
    rs = np.random.RandomState(4)
    x = rs.randn(2, 12, cfg.d_model).astype(np.float32)
    cases = [dict(causal=False, use_rope=False),
             dict(causal=False, use_rope=False, x_kv=20),
             dict(causal=False, use_rope=False, x_kv=5),
             dict(causal=True, x_kv=20, positions=8, kv_positions=0)]
    for case in cases:
        kw = dict(case)
        jkw, tkw = {}, {}
        if "x_kv" in kw:
            kv = rs.randn(2, kw.pop("x_kv"), cfg.d_model).astype(np.float32)
            jkw["x_kv"], tkw["x_kv"] = jnp.asarray(kv), torch.tensor(kv)
        for k in ("positions", "kv_positions"):
            if k in kw:
                n = 12 if k == "positions" else kv.shape[1]
                pos = np.arange(n)[None] + kw.pop(k)
                jkw[k], tkw[k] = jnp.asarray(pos), torch.tensor(pos)
        want = jattn.attention_forward(jp, jnp.asarray(x), jcfg, **kw, **jkw)
        got = attn.attention_forward(tp, torch.tensor(x), cfg, **kw, **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=str(case), **FWD_TOL)
    enc = rs.randn(2, cfg.n_frames, cfg.d_model).astype(np.float32)
    jk, jv = jattn.cross_attention_cache(jp, jnp.asarray(enc), jcfg)
    tk, tv = attn.cross_attention_cache(tp, torch.tensor(enc), cfg)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **FWD_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **FWD_TOL)
    np.testing.assert_allclose(
        attn.cross_attention_decode(tp, torch.tensor(x[:, :1]), cfg, tk,
                                    tv).numpy(),
        np.asarray(jattn.cross_attention_decode(jp, jnp.asarray(x[:, :1]),
                                                jcfg, jk, jv)), **FWD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_modalities_equal_the_reference_launchers(arch):
    """``add_modalities`` draws the reference launcher's patches and
    frames bit for bit from the same seed, round after round."""
    cfg = base.get_config(arch).reduced()
    jrng, trng = np.random.RandomState(7), np.random.RandomState(7)
    for lead in ((G, PER_GROUP, SEQ), (G * PER_GROUP, SEQ)):
        tokens = np.zeros(lead, np.int32)
        want = jtrain.add_modalities({"tokens": jnp.asarray(tokens)},
                                     jbase.get_config(arch).reduced(), jrng)
        got = train.add_modalities({"tokens": torch.tensor(tokens)}, cfg,
                                   trng)
        assert set(got) == set(want) and len(got) == 2
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            assert got[k].dtype == (torch.int32 if k == "tokens"
                                    else torch.float32)


def test_params_round_trip_through_checkpoint_and_bridge(both, tmp_path):
    """The reference's params saved by its checkpoint format restore in
    the port (and the port's in the reference), and the flat npz mapping
    goes through ``bridge.params_from_numpy``: all bit for bit."""
    jmodel, tmodel, params, _ = both
    jckpt.save(str(tmp_path / "ref"), params)
    got = ckpt.load(str(tmp_path / "ref"), tmodel.abstract())
    flat = dict(np.load(str(tmp_path / "ref") + ".npz"))
    via_bridge = bridge.params_from_numpy(flat)
    ckpt.save(str(tmp_path / "port"), got)
    back = jckpt.load(str(tmp_path / "port"), jmodel.abstract())
    for path, want in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [p.key for p in path]
        for t in (got, via_bridge):
            leaf = t
            for k in keys:
                leaf = leaf[k]
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(want))
        leaf = back
        for k in keys:
            leaf = leaf[k]
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(want))


def _batches(cfg, lead):
    """ROUNDS batches of tokens with the launchers' modality inputs."""
    toks = TokenPipeline(cfg.vocab_size, SEQ, seed=5).batches(lead)
    rng = np.random.RandomState(6)
    return [jtrain.add_modalities({"tokens": next(toks)["tokens"]}, cfg, rng)
            for _ in range(ROUNDS)]


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "pytree"])
@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_rounds_match_reference(both, packed, opt):
    jmodel, tmodel, params, _ = both
    batches = _batches(jmodel.cfg, (G, PER_GROUP))
    kw = dict(n_groups=G, inner_steps=T)
    tparams = bridge.params_from_numpy(params)
    if packed:
        jopt = joptim.get(opt, LR[opt], packed=True, impl="pallas")
        topt = optim.get(opt, LR[opt], packed=True)
        jl, tl = jpacking.layout_of(params), packing.layout_of(tparams)
    else:
        jopt, topt = joptim.get(opt, LR[opt]), optim.get(opt, LR[opt])
        jl = tl = None
    jrnd = jax.jit(jlsgd.make_local_round(
        jmodel.loss, jopt, jlsgd.LocalSGDConfig(**kw), layout=jl))
    jstate = jlsgd.init_state(params, jopt, n_groups=G, layout=jl)
    trnd = lsgd.make_local_round(tmodel.loss, topt,
                                 lsgd.LocalSGDConfig(**kw), layout=tl)
    tstate = lsgd.init_state(tparams, topt, G, tl)
    for b in batches:
        jstate, jm = jrnd(jstate, _j(jax.device_get(b)))
        tstate, tm = trnd(tstate, _t(jax.device_get(b)))
        assert set(tm) == set(jm)
        for k, jv in jax.device_get(jm).items():
            if k.startswith("wire_bytes") or k == "inner_steps":
                np.testing.assert_array_equal(np.asarray(tm[k]),
                                              np.asarray(jv))
            else:
                np.testing.assert_allclose(np.asarray(tm[k]), np.asarray(jv),
                                           err_msg=k, **ROUND_TOL)
    # (G, N) buffers, or the (G, ...) leaves in the one key order
    got = np.concatenate([np.ravel(x.numpy())
                          for x in tree.leaves(tstate["params"])])
    want = np.concatenate([np.ravel(np.asarray(x))
                           for x in jax.tree.leaves(jstate["params"])])
    if opt == "sgd":
        np.testing.assert_allclose(got, want, **ROUND_TOL)
        return
    diff = np.abs(got - want)
    stray = diff > ADAMW_PARAMS_TOL["atol"] + \
        ADAMW_PARAMS_TOL["rtol"] * np.abs(want)
    assert stray.mean() <= ADAMW_STRAY, (stray.sum(), stray.size)
    assert diff.max() <= 2 * T * ROUNDS * LR["adamw"], diff.max()
