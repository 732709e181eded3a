"""The port's packed layout against the reference's: same leaf order,
offsets, sizes and shapes, and the same buffer bit for bit, for the
paper-mlp params the reference makes (carried over with
``repro_torch.bridge``)."""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import io as ckpt_io
from repro.configs.base import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.optim import packing as jpacking
from repro_torch import bridge
from repro_torch.optim import packing


@pytest.fixture(scope="module")
def jax_params():
    model = jax_build_model(jax_get_config("paper-mlp"), schedule="rect")
    return jax.device_get(model.init(jax.random.PRNGKey(0)))


def test_layout_equals_reference(jax_params):
    jl = jpacking.layout_of(jax_params)
    tl = packing.layout_of(bridge.params_from_numpy(jax_params))
    assert tl.offsets == jl.offsets
    assert tl.sizes == jl.sizes
    assert tl.shapes == jl.shapes
    assert tl.size == jl.size == tl.padded
    jpaths = [tuple(k.key for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jax_params)[0]]
    assert list(tl.paths) == jpaths
    # sorted keys put the stacked blocks first
    assert tl.paths[0][0] == "blocks" and tl.paths[-1] == ("lm_head",)


def test_pack_equals_reference_and_unpack_inverts(jax_params):
    jl = jpacking.layout_of(jax_params)
    params = bridge.params_from_numpy(jax_params)
    tl = packing.layout_of(params)
    buf = packing.pack(params, tl)
    np.testing.assert_array_equal(buf.numpy(),
                                  np.asarray(jpacking.pack(jax_params, jl)))
    back = packing.unpack(buf, tl)
    for path, leaf in zip(tl.paths, jax.tree_util.tree_leaves(jax_params)):
        node = back
        for k in path:
            node = node[k]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
        # a view of the buffer, not a copy
        assert node.untyped_storage().data_ptr() == \
            buf.untyped_storage().data_ptr()
    np.testing.assert_array_equal(packing.pack(back, tl).numpy(), buf.numpy())


def test_grouped_pack_and_npz_bridge(jax_params, tmp_path):
    """A (G, ...) tree packs to (G, N) like the reference's; the flat
    npz of ``repro/checkpoint/io.py`` bridges to the same tree."""
    G = 3
    grouped = jax.tree.map(lambda x: np.stack([x * (g + 1) for g in range(G)]),
                           jax_params)
    jl = jpacking.layout_of(jax_params)
    tl = packing.layout_of(bridge.params_from_numpy(jax_params))
    buf_G = packing.pack(bridge.params_from_numpy(grouped), tl)
    assert buf_G.shape == (G, tl.size)
    np.testing.assert_array_equal(buf_G.numpy(),
                                  np.asarray(jpacking.pack(grouped, jl)))
    ckpt_io.save(str(tmp_path / "ck"), jax_params)
    from_npz = bridge.params_from_numpy(dict(np.load(tmp_path / "ck.npz")))
    np.testing.assert_array_equal(packing.pack(from_npz, tl).numpy(),
                                  buf_G[0].numpy())
    np.testing.assert_array_equal(
        bridge.buffer_from_numpy(np.asarray(jpacking.pack(grouped, jl))),
        buf_G)


def test_index_space_check_matches_reference():
    big = packing.Layout((("w",),), ((2**30,),), (torch.float32,), (0,),
                         (2**30,), 2**30)
    packing.check_packed_index_space(big, 1)
    with pytest.raises(NotImplementedError, match="int32"):
        packing.check_packed_index_space(big, 2)
