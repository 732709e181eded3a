"""Flat-buffer wire codecs (counterpart of ``repro/comm/codecs.py``;
DESIGN.md §8).

A codec compresses what a group puts on the wire each round. Lossy
codecs encode the round DELTA ``x_T - x_0``, not the model: deltas
shrink as training converges, so the quantization error vanishes with
them. ``fp32`` is the identity, and the exchange skips the delta
arithmetic for it.

Contract, as in the reference:
  * ``compress(delta, state) -> (delta_hat, state)``: quantize and
    decode in one step (the simulated wire), on a (G, N) buffer; the
    cast codecs (fp16, bf16) take a tree of (G, ...) leaves as well,
    leaf by leaf, as the reference's ``jax.tree.map`` does.
  * ``state`` carries a codec's memory from round to round in the train
    state (``state["comm"]["codec"][stream]``): int8's noise counter,
    top-k's error-feedback residual; ``{}`` for stateless codecs.
  * ``wire_bytes(n)``: the exact payload one sender puts on the wire for
    an n-element float32 buffer.

int8's stochastic-rounding noise cannot be the reference's (it draws
``jax.random`` bits). By default it comes from a ``torch.Generator`` on
the buffer's device, seeded from the codec's seed and the counter, so a
run and its rerun draw the same bits. The counter lives on the host (a
CPU tensor), so reading it never waits for the card. A ``noise_fn(count,
rows_shape) -> u`` hook replaces the generator: the parity tests feed
the reference's own bits through it. On a CUDA buffer the quantize +
decode core launches the ``qdq_int8`` kernel.

``defer_undelivered`` keeps error feedback honest under packet loss: a
dropped push's shipped entries go back into its residual.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.kernels.exchange_epilogue import qdq_int8
from repro_torch.optim import packing


@dataclasses.dataclass(frozen=True)
class Codec:
    name: str
    compress: Callable[[Any, dict], tuple]
    wire_bytes: Callable[[int], int]
    init: Callable[[Any], dict]
    # identity codecs skip the delta path entirely
    identity: bool = False
    stateful: bool = False
    # element-wise (or chunk-local) on the wire: runs on one rank's shard
    # of the buffer (``sharding/shardexec.py``)
    shardable: bool = True
    impl: str = "auto"
    # chunked codecs (int8, int8z) expose their per-(rows, chunk) core:
    #   noise(count, rows_shape, device) -> u   (deterministic per count)
    #   compress_rows(rows, u) -> decoded rows
    chunk: int = 0
    noise: Optional[Callable] = None
    compress_rows: Optional[Callable] = None
    # top-k selection fraction (0 for non-selective codecs)
    topk_frac: float = 0.0


def _no_state(_params_like):
    return {}


def fp32() -> Codec:
    """Identity: the uncompressed baseline (4 bytes/element)."""
    return Codec("fp32", lambda d, s: (d, s), lambda n: 4 * n, _no_state,
                 identity=True)


def _cast_codec(name: str, dtype, impl: str) -> Codec:
    def compress(delta, state):
        return tree.tree_map(lambda d: d.to(dtype).to(d.dtype), delta), state

    # impl reaches the fused exchange's codec_mix
    return Codec(name, compress, lambda n: 2 * n, _no_state, impl=impl)


def fp16(*, impl: str = "auto") -> Codec:
    return _cast_codec("fp16", torch.float16, impl)


def bf16(*, impl: str = "auto") -> Codec:
    return _cast_codec("bf16", torch.bfloat16, impl)


def generator_seed(seed: int, count: int) -> int:
    """The 64-bit ``torch.Generator`` seed of one compress application:
    (seed, count) through the splitmix64 finalizer, so that every bit,
    the low 32 that seed the CPU generator included, depends on both."""
    m = 0xFFFFFFFFFFFFFFFF
    z = ((((seed & 0xFFFFFFFF) << 32) | (count & 0xFFFFFFFF))
         + 0x9E3779B97F4A7C15) & m
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
    return z ^ (z >> 31)


def int8(chunk: int = 256, seed: int = 0, *, impl: str = "auto",
         noise_fn: Optional[Callable] = None) -> Codec:
    """Per-chunk-scaled int8 with unbiased stochastic rounding.

    Payload: 1 byte/element + one fp32 scale per ``chunk`` elements. The
    noise counter in the codec state makes the noise deterministic per
    compress application; ``noise_fn(count, rows_shape)`` (numpy or a
    tensor) replaces the default generator."""

    def init(_params_like):
        return {"count": torch.zeros((), dtype=torch.int32)}

    def noise(count, rows_shape, device):
        """Uniform [0, 1) noise of ``rows_shape`` for one compress
        application, deterministic per (seed, count)."""
        count = int(count)
        if noise_fn is not None:
            return torch.tensor(np.asarray(noise_fn(count, rows_shape),
                                           np.float32), device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(generator_seed(seed, count))
        return torch.rand(rows_shape, generator=gen, device=device)

    def compress_rows(rows, u):
        """Quantize + decode (rows, chunk) with the given noise."""
        return qdq_int8(rows, u, impl=impl)

    def compress(delta, state):
        rows = packing.chunk_rows(delta, chunk)
        out = compress_rows(rows, noise(state["count"], tuple(rows.shape),
                                        rows.device))
        return (packing.unchunk_rows(out, delta.shape),
                {"count": state["count"] + 1})

    return Codec("int8", compress,
                 lambda n: n + 4 * math.ceil(n / chunk), init,
                 stateful=True, impl=impl,
                 chunk=chunk, noise=noise, compress_rows=compress_rows)


def int8z(chunk: int = 256, seed: int = 0, *, impl: str = "auto",
          noise_fn: Optional[Callable] = None) -> Codec:
    """Zero-preserving int8, the moment codec (DESIGN.md §10): the same
    wire format and bytes as ``int8``, but every element smaller than
    half a quantum rounds to exact zero: the noise is pinned to 0.5 where
    ``|row| < scale/2`` (computed from the row alone, before the int8
    core), so ``floor(x/s + 0.5) == 0`` there. Elements at or above half
    a quantum keep int8's stochastic rounding."""
    base = int8(chunk=chunk, seed=seed, impl=impl, noise_fn=noise_fn)

    def compress_rows(rows, u):
        amax = rows.abs().amax(dim=-1, keepdim=True)
        scale = torch.where(amax > 0, amax / amax.new_tensor(127.0),
                            torch.ones_like(amax))
        u = torch.where(rows.abs() < 0.5 * scale, torch.full_like(u, 0.5), u)
        return base.compress_rows(rows, u)

    def compress(delta, state):
        rows = packing.chunk_rows(delta, chunk)
        out = compress_rows(rows, base.noise(state["count"],
                                             tuple(rows.shape), rows.device))
        return (packing.unchunk_rows(out, delta.shape),
                {"count": state["count"] + 1})

    return dataclasses.replace(base, name="int8z", compress=compress,
                               compress_rows=compress_rows)


def topk(frac: float = 0.05, *, impl: str = "auto") -> Codec:
    """Magnitude top-k sparsification with error feedback: only the
    k = max(1, round(frac*N)) largest-|.| entries of each row go on the
    wire (4-byte value + 4-byte index each); the rest accumulate in a
    per-group residual and are offered again next round. ``delta +
    residual_in == delta_hat + residual_out`` holds exactly. ``compress``
    is the staged exact selection (ring/gossip, per hop); the server
    topology routes top-k through the fused ``codec_mix`` thresh kernel."""

    def init(params_like):
        return {"residual": torch.zeros_like(params_like)}

    def compress(delta, state):
        c = delta + state["residual"]
        k = max(1, int(round(frac * c.shape[-1])))
        idx = torch.topk(c.abs(), k, dim=-1, sorted=False).indices
        d_hat = torch.zeros_like(c).scatter_(-1, idx, c.gather(-1, idx))
        return d_hat, {"residual": c - d_hat}

    def wire_bytes(n):
        return 8 * max(1, int(round(frac * n)))

    return Codec("topk", compress, wire_bytes, init, stateful=True,
                 impl=impl, topk_frac=frac)


def defer_undelivered(state: dict, d_hat, delivered):
    """Error feedback under packet loss (DESIGN.md §12): ``compress``
    already moved the shipped entries out of the residual; where group
    g's push was dropped (``delivered[g] == 0``, a (G,) float mask on
    d_hat's device) they go back in, restoring ``residual = c``, and are
    offered again next round. No-op for a state without a residual
    (int8's counter advances either way: the noise was spent)."""
    if "residual" not in state:
        return state
    keep = delivered.reshape((-1,) + (1,) * (d_hat.dim() - 1))
    return {**state, "residual": state["residual"] + (1.0 - keep) * d_hat}


CODECS = ("fp32", "fp16", "bf16", "int8", "int8z", "topk")


def get_codec(name: str, *, impl: str = "auto", chunk: int = 256,
              topk_frac: float = 0.05, seed: int = 0,
              noise_fn: Optional[Callable] = None) -> Codec:
    if name == "fp32":
        return fp32()
    if name == "fp16":
        return fp16(impl=impl)
    if name == "bf16":
        return bf16(impl=impl)
    if name == "int8":
        return int8(chunk=chunk, seed=seed, impl=impl, noise_fn=noise_fn)
    if name == "int8z":
        return int8z(chunk=chunk, seed=seed, impl=impl, noise_fn=noise_fn)
    if name == "topk":
        return topk(frac=topk_frac, impl=impl)
    raise ValueError(f"unknown codec {name!r}: valid codecs are {CODECS}")
