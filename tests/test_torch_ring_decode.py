"""The reference's ring-cache serving API in the port, on every
architecture's reduction (2 layers, d 256, float32) with the reference's
params from ``PRNGKey(0)``: ``init_cache`` (tree, shapes, dtypes and the
-1 ``slot_pos`` exactly), ``decode_step`` at positions 0, 1, W-1, W and
W+3 of a W-slot ring (past the window the oldest slot is overwritten),
the dense and moe ``prefill``, and ``Model.logits``; then, on the port
alone, stepwise decode against its own forward (whisper through the
encoder's cross caches, in both packages), and the batched prefill
against stepwise decode (``tests/test_archs.py``'s contracts).

Tolerance: logits and caches rtol 1e-5 / atol 1e-5 (float32 products that
XLA and PyTorch sum in another order, as ``test_torch_families.py``);
the port's decode against its own forward within the same bound, and the
reference test's 5e-2 on log-probabilities for the next-token checks."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro_torch import bridge, tree
from repro_torch.configs import base
from repro_torch.models import attention as attn
from repro_torch.models.api import build_model

TOL = dict(rtol=1e-5, atol=1e-5)
NEXT_TOKEN = 5e-2            # tests/test_archs.py's log-softmax contract
B, W, S = 2, 8, 16            # S: a whole number of the reduced chunk (8)
POSITIONS = (0, 1, W - 1, W, W + 3)
PREFILL_S, PREFILL_W = 6, 12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the port's side: its many small ops stall
    for a scheduler slice each when the machine is loaded, as under the
    parallel suite (ROADMAP.md, ground rules: tests)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(cfg, seq, seed=1):
    rs = np.random.RandomState(seed)
    batch = {"tokens": rs.randint(0, cfg.vocab_size,
                                  size=(B, seq)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rs.randn(B, cfg.n_patches,
                                    cfg.d_model).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rs.randn(B, cfg.n_frames,
                                   cfg.d_model).astype(np.float32)
    return batch


def _tensors(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=jbase.ARCH_IDS)
def ref(request):
    """Both models of one reduction, the reference's params, and the
    reference's runs: logits, the empty cache, the cache after each of
    POSITIONS with that step's logits, and the dense/moe prefill."""
    jcfg = jbase.get_config(request.param).reduced()
    jmodel = jbuild_model(jcfg)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    batch = _inputs(jcfg, S)
    out = {"cfg": jcfg, "params": params, "batch": batch,
           "tmodel": build_model(base.get_config(request.param).reduced()),
           "tparams": bridge.params_from_numpy(params),
           "logits": np.asarray(jmodel.logits(
               params, {k: jnp.asarray(v) for k, v in batch.items()})),
           "cache0": jax.device_get(jmodel.init_cache(B, W))}
    step = jax.jit(jmodel.decode_step)
    cache, steps = out["cache0"], []
    for pos in POSITIONS:
        tok = batch["tokens"][:, pos % S][:, None]
        logits, cache = step(params, cache, jnp.asarray(tok),
                             jnp.asarray(pos, jnp.int32))
        steps.append((pos, tok, np.asarray(logits), jax.device_get(cache)))
    out["steps"] = steps
    out["prefill"] = None
    if hasattr(jmodel, "prefill"):
        logits, cache = jmodel.prefill(
            params, {"tokens": jnp.asarray(batch["tokens"][:, :PREFILL_S])},
            PREFILL_W)
        out["prefill"] = (np.asarray(logits), jax.device_get(cache))
    return out


def _paths(jtree):
    return [tuple(k.key for k in p)
            for p, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]


def _assert_tree(ttree, jtree, exact=False):
    assert tree.flatten(ttree)[0] == _paths(jtree)
    for got, want in zip(tree.leaves(ttree), jax.tree.leaves(jtree)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        assert str(got.dtype) == f"torch.{want.dtype}"
        if exact:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_init_cache_matches_reference(ref):
    _assert_tree(ref["tmodel"].init_cache(B, W), ref["cache0"], exact=True)


def test_decode_steps_match_reference_across_the_window(ref):
    """Positions W and W+3 overwrite slots 0 and 3 of the ring."""
    tmodel, tparams = ref["tmodel"], ref["tparams"]
    cache = tmodel.init_cache(B, W)
    for pos, tok, jlogits, jcache in ref["steps"]:
        logits, cache = tmodel.decode_step(tparams, cache, torch.tensor(tok),
                                           pos)
        assert logits.shape == (B, 1, tmodel.cfg.padded_vocab)
        np.testing.assert_allclose(logits.numpy(), jlogits, **TOL)
        _assert_tree(cache, jcache)
    if "kv" in cache:
        assert cache["kv"]["slot_pos"][0].tolist() == \
            [W, 1, -1, W + 3, -1, -1, -1, W - 1]


def test_prefill_matches_reference(ref):
    tmodel = ref["tmodel"]
    assert hasattr(tmodel, "prefill") == (ref["prefill"] is not None)
    if ref["prefill"] is None:
        return
    jlogits, jcache = ref["prefill"]
    toks = torch.tensor(ref["batch"]["tokens"][:, :PREFILL_S])
    logits, cache = tmodel.prefill(ref["tparams"], {"tokens": toks},
                                   PREFILL_W)
    np.testing.assert_allclose(logits.numpy(), jlogits, **TOL)
    _assert_tree(cache, jcache)
    assert cache["kv"]["slot_pos"][:, PREFILL_S:].eq(-1).all()


def test_logits_match_reference(ref):
    got = ref["tmodel"].logits(ref["tparams"], _tensors(ref["batch"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref["logits"], **TOL)


def _stepwise(model, params, tokens, cache_len, frames=None):
    """The tokens (B, S) through ``decode_step`` one at a time from an
    empty cache (whisper's cross caches filled from ``encode`` first):
    (the (B, S, V) logits, the cache)."""
    cache = model.init_cache(tokens.shape[0], cache_len)
    if frames is not None:
        enc = model.encode(params, frames)
        ks, vs = zip(*(attn.cross_attention_cache(p["cross_attn"], enc,
                                                  model.cfg)
                       for p in _layers(params["dec"], model.cfg.n_layers)))
        cache["cross_k"], cache["cross_v"] = torch.stack(ks), torch.stack(vs)
    out = []
    for t in range(tokens.shape[1]):
        logits, cache = model.decode_step(params, cache, tokens[:, t:t + 1],
                                          t)
        out.append(logits)
    return torch.cat(out, 1), cache


def _layers(stacked, n):
    return [tree.tree_map(lambda a: a[i], stacked) for i in range(n)]


def test_stepwise_decode_matches_own_forward(ref):
    """With a cache at least as long as the sequence, decoding token by
    token gives the forward's logits (vlm: text only, as the reference
    decodes; whisper: over the encoder output's cross caches)."""
    tmodel, tparams = ref["tmodel"], ref["tparams"]
    batch = _tensors(ref["batch"])
    batch.pop("patches", None)
    stepped, _ = _stepwise(tmodel, tparams, batch["tokens"], S,
                           batch.get("frames"))
    full = tmodel.logits(tparams, batch)
    np.testing.assert_allclose(stepped.numpy(), full.numpy(), **TOL)


def test_batched_prefill_matches_stepwise(ref):
    """tests/test_archs.py's check on the port: the prefilled cache and
    the stepwise one give the same next-token distribution, and decoding
    on from either agrees too."""
    tmodel, tparams = ref["tmodel"], ref["tparams"]
    if not hasattr(tmodel, "prefill"):
        # the batched prefill is the dense and moe decoders', as in the
        # reference: the others fill their caches step by step
        assert tmodel.cfg.family not in ("dense", "moe")
        return
    toks = torch.tensor(ref["batch"]["tokens"][:, :PREFILL_S])
    logits_pf, cache_pf = tmodel.prefill(tparams, {"tokens": toks},
                                         PREFILL_W)
    stepped, cache = _stepwise(tmodel, tparams, toks, PREFILL_W)

    def logp(x):
        return torch.log_softmax(x[:, -1], -1)

    assert float((logp(logits_pf) - logp(stepped)).abs().max()) < NEXT_TOKEN
    nxt = logits_pf[:, :, :tmodel.cfg.vocab_size].argmax(-1).to(torch.int32)
    l1, _ = tmodel.decode_step(tparams, cache_pf, nxt, PREFILL_S)
    l2, _ = tmodel.decode_step(tparams, cache, nxt, PREFILL_S)
    assert float((logp(l1) - logp(l2)).abs().max()) < NEXT_TOKEN


def test_whisper_decode_equals_teacher_forced_in_both_packages():
    """Whisper's decode over the cross caches of ``encode`` gives the
    teacher-forced logits, in the reference and in the port, and the two
    packages agree step for step."""
    jcfg = jbase.get_config("whisper-base").reduced()
    jmodel = jbuild_model(jcfg)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    batch = _inputs(jcfg, S, seed=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    enc = jmodel.encode(params, jb["frames"])
    cache = jmodel.init_cache(B, S)
    ks, vs = zip(*(jattn.cross_attention_cache(
        jax.tree.map(lambda a: a[i], params["dec"]["cross_attn"]), enc, jcfg)
        for i in range(jcfg.n_layers)))
    cache = dict(cache, cross_k=jnp.stack(ks), cross_v=jnp.stack(vs))
    step = jax.jit(jmodel.decode_step)
    jsteps = []
    for t in range(S):
        logits, cache = step(params, cache, jb["tokens"][:, t:t + 1],
                             jnp.asarray(t, jnp.int32))
        jsteps.append(np.asarray(logits))
    jsteps = np.concatenate(jsteps, 1)
    jfull = np.asarray(jmodel.logits(params, jb))
    np.testing.assert_allclose(jsteps, jfull, **TOL)

    tmodel = build_model(base.get_config("whisper-base").reduced())
    tparams = bridge.params_from_numpy(params)
    tb = _tensors(batch)
    tsteps, _ = _stepwise(tmodel, tparams, tb["tokens"], S, tb["frames"])
    np.testing.assert_allclose(tsteps.numpy(), jsteps, **TOL)
    np.testing.assert_allclose(tmodel.logits(tparams, tb).numpy(), jfull,
                               **TOL)


@pytest.mark.parametrize("arch", ["qwen3-32b", "internvl2-1b"])
def test_kv_cache_helpers_match_reference(arch):
    """``init_kv_cache`` / ``kv_cache_shapes`` (one layer's ring) and a
    ring decode of one layer, qk-norm (qwen3) and qkv bias (internvl2)
    included."""
    cfg = base.get_config(arch).reduced()
    jcfg = jbase.get_config(arch).reduced()
    want = jattn.init_kv_cache(jcfg, B, W, jnp.float32)
    got = attn.init_kv_cache(cfg, B, W, torch.float32)
    _assert_tree(got, jax.device_get(want), exact=True)
    shapes = attn.kv_cache_shapes(cfg, B, W, torch.bfloat16)
    for k, s in jattn.kv_cache_shapes(jcfg, B, W, jnp.bfloat16).items():
        assert shapes[k] == (s.shape, getattr(torch, str(s.dtype)))
    jp = jax.device_get(jbuild_model(jcfg).init(jax.random.PRNGKey(0)))
    jp = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    tp = bridge.params_from_numpy(jp)
    x = np.random.RandomState(3).randn(B, 1, cfg.d_model).astype(np.float32)
    for pos in (0, W + 1):
        jy, want = jattn.decode_attention(jp, jnp.asarray(x), jcfg, want,
                                          jnp.asarray(pos, jnp.int32))
        y, got = attn.decode_attention(tp, torch.tensor(x), cfg, got, pos)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        _assert_tree(got, jax.device_get(want))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
