"""Layer primitives and the ParamDef declarations (counterpart of
``repro/models/layers.py``).

Params are declared as a tree of ``ParamDef`` leaves (shape, logical
axes, init); ``init_params`` materializes them as a nested dict of
float32 tensors. Random init draws from a ``torch.Generator``, so its
numbers differ from the reference's ``jax.random`` ones; to compare the
two packages, load the reference's params through ``repro_torch.bridge``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declaration of one parameter tensor."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis names, same rank as shape
    init: str = "normal"             # normal | zeros | ones | small_normal
    scale: float = 0.02
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def pdef(shape, axes, init="normal", scale=0.02, dtype="float32") -> ParamDef:
    return ParamDef(tuple(shape), tuple(axes), init, scale, dtype)


def stack_defs(defs, n: int, axis_name: str = "layers"):
    """Prepend a stacked leading axis (one slice per layer)."""
    return tree.tree_map(
        lambda d: ParamDef((n,) + d.shape, (axis_name,) + d.axes, d.init,
                           d.scale, d.dtype), defs)


def _materialize(d: ParamDef, generator: torch.Generator, device):
    dt = getattr(torch, d.dtype)
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=device)
    scale = d.scale * 0.1 if d.init == "small_normal" else d.scale
    x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * scale).to(device=device, dtype=dt)


def init_params(defs, generator: torch.Generator, device="cpu"):
    """Materialize a ParamDef tree into a nested dict of tensors, drawing
    the leaves in the tree's sorted-key order."""
    return tree.tree_map(lambda d: _materialize(d, generator, device), defs)


def rms_norm(x, weight, eps: float = 1e-5):
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)).to(dt)


def rope_frequencies(head_dim: int, theta: float, device="cpu"):
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """Rotary embedding on split halves (not interleaved).
    x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    inv = rope_frequencies(x.shape[-1], theta, x.device)   # (hd/2,)
    ang = positions[..., None].to(torch.float32) * inv     # (..., S, hd/2)
    sin = torch.sin(ang)[..., None, :]                     # (..., S, 1, hd/2)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
