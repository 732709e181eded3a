"""Checkpoint -> serve handoff: restore trained params into the serve
model (counterpart of ``repro/serve/handoff.py``).

Two accepted checkpoint formats, both written by ``checkpoint/io.py`` of
either package:

  pytree  the averaged server params that ``launch/train.py
          --checkpoint`` saves, keys matching ``model.abstract()``.
  packed  one flat f32 buffer under the key ``"buf"``: ``(size,)`` or
          ``(G, size)`` (groups averaged, as ``server_params`` does),
          unpacked through the model's ``optim/packing`` Layout, whose
          leaf order is the reference's.

The checkpoint's ``arch`` metadata must match the serve config when
present.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.optim.packing import layout_of, unpack


def restore_params(path: str, model, check_arch: bool = True,
                   device="cuda"):
    """Load ``path`` (npz + json, no extension) into ``model``'s param
    structure on ``device``."""
    try:
        meta = ckpt_io.load_metadata(path)
    except FileNotFoundError:
        meta = {}
    if check_arch and meta.get("arch") and meta["arch"] != model.cfg.name:
        raise ValueError(
            f"checkpoint {path!r} was trained for arch {meta['arch']!r}, "
            f"serve config is {model.cfg.name!r} — pass the matching "
            "--arch, or check_arch=False to force")
    like = model.abstract()
    try:
        params = ckpt_io.load(path, like)
    except KeyError:
        params = _restore_packed(path, like)
    return tree.tree_map(lambda x: x.to(device), params)


def _restore_packed(path: str, like):
    try:
        buf = ckpt_io.load(path, {"buf": 0})["buf"].numpy()
    except KeyError:
        raise ValueError(
            f"checkpoint {path!r} matches neither the params pytree nor "
            "the packed {'buf': ...} format") from None
    buf = np.asarray(buf, np.float32)
    if buf.ndim > 1:                  # (G, size): average the groups
        buf = buf.mean(axis=0)
    layout = layout_of(like)
    if buf.shape[-1] < layout.size:
        raise ValueError(
            f"packed checkpoint buffer has {buf.shape[-1]:,} elements, "
            f"arch needs {layout.size:,} — wrong config?")
    return unpack(torch.from_numpy(np.ascontiguousarray(buf[:layout.size])),
                  layout)
