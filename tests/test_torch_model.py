"""The port's dense model against the reference's on the same params and
batch: the loss and the flat gradient (``value_and_flat_grad``).

Tolerance: loss rtol 1e-5; gradients rtol 1e-4 / atol 1e-6. Both
packages compute in float32 with the same formulas, but the matrix
products and reductions of XLA's CPU backend and PyTorch's accumulate in
different orders, which moves the float32 gradients by a few 1e-6
relative through the backward chain; 1e-4 leaves room for that and
still fails on any wrong term."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.optim import packing as jpacking
from repro_torch import bridge, tree
from repro_torch.configs.base import get_config
from repro_torch.models.api import build_model
from repro_torch.optim import packing

TINY = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
            vocab_size=256)


def _both(name, seq, schedule, **changes):
    jcfg = dataclasses.replace(jax_get_config(name).reduced(), **changes)
    tcfg = dataclasses.replace(get_config(name).reduced(), **changes)
    jmodel = jax_build_model(jcfg, schedule=schedule)
    tmodel = build_model(tcfg, schedule=schedule)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(1)))
    tokens = np.random.RandomState(2).randint(
        0, jcfg.vocab_size, size=(2, seq)).astype(np.int32)
    return jmodel, tmodel, params, tokens


@pytest.mark.parametrize("name,seq,schedule,changes", [
    # paper-mlp reduced, seq 64 < block: the unblocked attention branch
    ("paper-mlp", 64, "rect", {}),
    # a tiny GQA decoder at seq 1024 = 2 blocks of 512: the blocked branch
    ("paper-mlp", 1024, "rect", TINY),
    ("paper-mlp", 1024, "tri", TINY),
    # the config-driven variants the dense family carries
    ("paper-mlp", 64, "rect", dict(TINY, mlp_type="gelu", qkv_bias=True)),
    ("paper-mlp", 64, "rect", dict(TINY, mlp_type="relu2", qk_norm=True)),
])
def test_loss_and_flat_grad_match_reference(name, seq, schedule, changes):
    jmodel, tmodel, params, tokens = _both(name, seq, schedule, **changes)
    jl = jpacking.layout_of(params)
    jloss, jgrad = jax.jit(jpacking.value_and_flat_grad(jmodel.loss, jl))(
        jpacking.pack(params, jl), {"tokens": jnp.asarray(tokens)})

    tparams = bridge.params_from_numpy(params)
    tl = packing.layout_of(tparams)
    tloss, tgrad = packing.value_and_flat_grad(tmodel.loss, tl)(
        packing.pack(tparams, tl), {"tokens": torch.tensor(tokens)})
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=1e-6)


def test_unported_paths_raise():
    """attn_impl="pallas" runs its forward through the flash kernel's
    plain version (the same loss as the blocked path, rtol 1e-5); a
    gradient through it raises, since the kernel has no backward in
    either package. The vlm and audio architectures and families build,
    their configs and param trees those of the reference."""
    cfg = dataclasses.replace(get_config("paper-mlp").reduced(), **TINY,
                              attn_impl="pallas")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.randint(0, 256, (1, 1024),
                                     generator=torch.Generator().manual_seed(1))}
    blocked = build_model(dataclasses.replace(cfg, attn_impl="blocked"))
    np.testing.assert_allclose(model.loss(params, batch).item(),
                               blocked.loss(params, batch).item(), rtol=1e-5)
    layout = packing.layout_of(params)
    with pytest.raises(NotImplementedError, match="flash_attention"):
        packing.value_and_flat_grad(model.loss, layout)(
            packing.pack(params, layout), batch)
    for arch in ("internvl2-1b", "whisper-base"):
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_get_config(arch))
    for fam in ("vlm", "audio"):
        tcfg = dataclasses.replace(cfg, family=fam)
        jcfg = dataclasses.replace(jax_get_config("paper-mlp").reduced(),
                                   **TINY, attn_impl="pallas", family=fam)
        assert {k: tuple(v.shape) for k, v in zip(*tree.flatten(
            build_model(tcfg).abstract()))} == {
            tuple(p.key for p in path): tuple(v.shape) for path, v in
            jax.tree_util.tree_flatten_with_path(
                jax_build_model(jcfg).abstract())[0]}
