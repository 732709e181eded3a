"""Parameter packing: tree <-> one contiguous float32 buffer (counterpart
of ``repro/optim/packing.py``; DESIGN.md §6).

A ``Layout`` is the static description of the buffer: leaf i occupies
``buf[..., offsets[i]:offsets[i]+sizes[i]]`` reshaped to ``shapes[i]``.
The leaf order is the reference's (dict keys sorted at every level, see
``repro_torch.tree``), so offsets, sizes and shapes equal
``repro.optim.packing.layout_of``'s for the same tree, and a buffer
means the same thing in both packages. Leading axes (the local-SGD G
axis) stack as leading buffer axes: a grouped tree packs to (G, N).

``unpack`` returns views of the buffer. Gradients are taken per leaf and
written into a flat buffer, never by differentiating through ``unpack``.
The buffer doubles as the wire format of the exchange: ``chunk_rows``
cuts it into the rows of 256 that carry one int8 scale each.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Tuple

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class Layout:
    """Static flat-buffer layout for one parameter tree."""
    paths: Tuple[Tuple[str, ...], ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    size: int                      # total number of f32 elements

    @property
    def padded(self) -> int:
        """Buffer length including trailing zero padding (== size here;
        ``ShardedLayout`` pads to a shard and chunk multiple)."""
        return self.size


@dataclasses.dataclass(frozen=True)
class ShardedLayout(Layout):
    """Shard-aware Layout (DESIGN.md §9): the buffer is zero-padded to
    ``pad_to``, a multiple of ``n_shards * align``, so it splits into
    ``n_shards`` equal shards of whole ``align``-element codec chunks (an
    int8 scale never straddles two ranks). ``unpack`` stops at ``size``;
    zero params with zero grads and moments stay zero under every packed
    optimizer, quantize to zero and average to zero, so the pad never
    leaks into real elements."""
    n_shards: int = 1
    align: int = 1
    pad_to: int = 0

    @property
    def padded(self) -> int:
        return self.pad_to

    @property
    def shard_size(self) -> int:
        return self.pad_to // self.n_shards


def shard_layout(layout: Layout, n_shards: int,
                 align: int = 256) -> ShardedLayout:
    """Pad a Layout for ``n_shards``-way in-group sharding; ``align``
    defaults to the int8 codec's chunk, so one geometry serves every
    codec."""
    if n_shards < 1 or align < 1:
        raise ValueError(f"n_shards={n_shards}, align={align}: both must "
                         "be >= 1")
    q = n_shards * align
    return ShardedLayout(layout.paths, layout.shapes, layout.dtypes,
                         layout.offsets, layout.sizes, layout.size,
                         n_shards=n_shards, align=align,
                         pad_to=q * -(-layout.size // q))


@dataclasses.dataclass(frozen=True)
class StreamLayout:
    """Named streams over one buffer geometry (DESIGN.md §10): the params
    plus the optimizer's moment buffers, each (..., base.padded)."""
    base: Layout
    streams: Tuple[str, ...]

    def __post_init__(self):
        if not self.streams or self.streams[0] != "params" \
                or len(set(self.streams)) != len(self.streams):
            raise ValueError(f"bad streams {self.streams}")

    @property
    def moment_streams(self) -> Tuple[str, ...]:
        return self.streams[1:]


def stream_layout_for(opt, layout: Layout) -> StreamLayout:
    """StreamLayout of a packed optimizer's state on ``layout``."""
    return StreamLayout(layout, ("params",) + tuple(opt.moment_keys))


INT32_INDEX_MAX = 2**31 - 1


def check_packed_index_space(layout: Layout, n_groups: int = 1) -> None:
    """Refuse the (n_groups, padded) state buffers the reference refuses:
    its XLA lowering indexes them with int32, so it cannot run a packed
    round past 2**31-1 elements. The port's kernels use 64-bit offsets;
    the check keeps the set of accepted configurations the same in both
    packages, so that every packed run has a reference to compare with."""
    total = n_groups * layout.padded
    if total > INT32_INDEX_MAX:
        raise NotImplementedError(
            f"packed state buffer ({n_groups} group(s) x {layout.padded:,}"
            f" f32 elements = {total:,}) exceeds the int32 index space "
            f"(2**31-1 = {INT32_INDEX_MAX:,}) of the reference's packed "
            "round; reduce the model or the group count")


def layout_of(params) -> Layout:
    """Build the static layout from a tree of tensors."""
    paths, leaves = tree.flatten(params)
    shapes = tuple(tuple(l.shape) for l in leaves)
    sizes = tuple(math.prod(s) for s in shapes)
    offsets = tuple(itertools.accumulate(sizes, initial=0))[:-1]
    return Layout(tuple(paths), shapes, tuple(l.dtype for l in leaves),
                  offsets, sizes, sum(sizes))


def pack(params, layout: Layout) -> torch.Tensor:
    """Concatenate a tree's leaves into the float32 buffer (zero-padded
    to ``layout.padded``); extra leading axes on the leaves (all the
    same) become leading buffer axes."""
    leaves = tree.leaves(params)
    lead = leaves[0].shape[:leaves[0].dim() - len(layout.shapes[0])]
    parts = [l.reshape(*lead, -1).to(torch.float32) for l in leaves]
    if layout.padded > layout.size:
        parts.append(parts[0].new_zeros(*lead, layout.padded - layout.size))
    return torch.cat(parts, dim=-1)


def unpack(buf: torch.Tensor, layout: Layout):
    """The tree of ``buf`` as views (leading axes carried onto every
    leaf); a leaf whose dtype is not float32 is a cast copy."""
    lead = tuple(buf.shape[:-1])
    return tree.unflatten(layout.paths, [
        buf[..., o:o + s].view(*lead, *sh).to(dt)
        for o, s, sh, dt in zip(layout.offsets, layout.sizes, layout.shapes,
                                layout.dtypes)])


def chunk_rows(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """(..., N) buffer -> (rows, chunk) view for the per-chunk codecs: the
    last axis zero-padded to a chunk multiple (zeros quantize to zero, so
    the pad never leaks into the payload), every leading axis flattened
    into the rows."""
    return pad_rows(x, chunk).reshape(-1, chunk)


def pad_rows(x: torch.Tensor, row: int) -> torch.Tensor:
    """(..., N) buffer -> (..., n_rows, row): ``chunk_rows`` that keeps
    the leading axes."""
    pad = (-x.shape[-1]) % row
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], -1, row)


def unchunk_rows(rows: torch.Tensor, shape) -> torch.Tensor:
    """Invert ``chunk_rows``: (rows, chunk) back to a ``shape`` buffer
    (the zero padding on the last axis is sliced off)."""
    lead = tuple(shape[:-1])
    return rows.reshape(*lead, -1)[..., :shape[-1]]


def value_and_leaf_grads(loss_fn, layout: Layout, buf, batch):
    """(loss, per-leaf gradients) of a tree loss at one (N,) buffer. The
    leaves are detached views of ``buf`` that require grad."""
    leaves = tree.leaves(unpack(buf.detach(), layout))
    for leaf in leaves:
        leaf.requires_grad_()
    loss = loss_fn(tree.unflatten(layout.paths, leaves), batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def value_and_flat_grad(loss_fn, layout: Layout):
    """``vg(buf, batch, out=None) -> (loss, flat_grad)`` for a tree loss
    and one (N,) buffer: each leaf's gradient is copied into its slice of
    ``out`` (a new (N,) buffer when not given); the pad region of a
    ``ShardedLayout`` gets zeros."""

    def flat_vg(buf, batch, out=None):
        loss, grads = value_and_leaf_grads(loss_fn, layout, buf, batch)
        if out is None:
            out = torch.empty_like(buf)
        for o, s, g in zip(layout.offsets, layout.sizes, grads):
            out[o:o + s].copy_(g.reshape(-1))
        out[layout.size:].zero_()
        return loss, out

    return flat_vg
