"""Optimizers (counterpart of ``repro/optim/__init__.py``).

API: ``opt = get("adamw", lr)``; ``state = opt.init(params)``;
``params, state = opt.step(params, grads, state)``.

* Pytree optimizers (``sgd``, ``momentum``, ``adamw``): params, grads and
  moments are trees of tensors (the moments mirror the param tree), and
  each step returns new tensors. They launch no kernel, as in the
  reference (its fused kernels exist only for the flat buffer).
* Packed optimizers (``packed("adamw", lr)``): params, grads and every
  moment are (G, N) float32 buffers (or one (N,) buffer, taken as its
  one-row view), and each step is one fused kernel launch over the
  whole buffer. The updates are IN PLACE: ``step`` overwrites ``buf``
  and the moment buffers of ``state`` (the reference gets the same
  effect from buffer donation under jit) and returns them together with
  the advanced step count. ``step(..., active=None)`` takes an optional
  (G,) bool mask: rows that are not active keep their params and
  moments, and a per-row count advances only where the row is active
  (the local round's t_i mask).
* Transforms over either kind: ``clip_by_global_norm``,
  ``cosine_schedule``, ``with_schedule``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch

from repro_torch import tree
from repro_torch.kernels.fused_adamw import fused_adamw
from repro_torch.kernels.fused_momentum import fused_momentum
from repro_torch.kernels.fused_sgd import fused_sgd
from repro_torch.kernels.ref import adamw_bias_correction


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    step: Callable
    name: str = "opt"
    # flat-buffer optimizer (fused kernels, in place) or pytree optimizer
    packed: bool = False
    # "auto" (the kernel on CUDA, the plain version on CPU), "torch" or
    # "cuda" — see repro_torch.kernels.resolve_impl
    impl: str = "auto"
    # the update depends on the step count (adamw's bias correction), so
    # under per-node t_i the round keeps one count per group
    count_dependent: bool = False
    # moment streams of the state (DESIGN.md §10), in a fixed order
    moment_keys: Tuple[str, ...] = ()
    # moment streams that are >= 0 (adamw's v): a lossy exchange projects
    # them back onto [0, inf) after decoding
    moment_nonneg: Tuple[str, ...] = ()


# ---------------------------------------------------------------------------
# Pytree optimizers
# ---------------------------------------------------------------------------


def _zeros_like_tree(params):
    return tree.tree_map(torch.zeros_like, params)


def _count_like(params):
    """A zero step count on the params' device."""
    leaf = tree.leaves(params)[0]
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return {"count": _count_like(params)}

    def step(params, grads, state):
        new = tree.tree_map(lambda p, g: p - lr * g.to(p.dtype), params,
                            grads)
        return new, {"count": state["count"] + 1}

    return Optimizer(init, step, "sgd")


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return {"count": _count_like(params),
                "mu": _zeros_like_tree(params)}

    def step(params, grads, state):
        mu = tree.tree_map(lambda m, g: beta * m + g.to(m.dtype),
                           state["mu"], grads)
        new = tree.tree_map(lambda p, m: p - lr * m, params, mu)
        return new, {"count": state["count"] + 1, "mu": mu}

    return Optimizer(init, step, "momentum", moment_keys=("mu",))


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"count": _count_like(params),
                "m": _zeros_like_tree(params),
                "v": _zeros_like_tree(params)}

    def step(params, grads, state):
        c = state["count"] + 1
        bc1, bc2 = adamw_bias_correction(c, b1, b2).unbind(-1)

        def upd(p, g, m, v):
            g = g.to(p.dtype)
            m_ = b1 * m + (1 - b1) * g
            v_ = b2 * v + (1 - b2) * torch.square(g)
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            return p - lr * (u + weight_decay * p), m_, v_

        paths, ps = tree.flatten(params)
        outs = [upd(*x) for x in zip(ps, tree.leaves(grads),
                                     tree.leaves(state["m"]),
                                     tree.leaves(state["v"]))]
        new_p, new_m, new_v = (tree.unflatten(paths, [o[i] for o in outs])
                               for i in range(3))
        return new_p, {"count": c, "m": new_m, "v": new_v}

    return Optimizer(init, step, "adamw", count_dependent=True,
                     moment_keys=("m", "v"), moment_nonneg=("v",))


# ---------------------------------------------------------------------------
# Packed optimizers: flat float32 buffers and fused update kernels
# ---------------------------------------------------------------------------


def _rows(x):
    """A (G, N) buffer as it is; one (N,) buffer as its (1, N) view."""
    return x if x.dim() == 2 else x.view(1, -1)


def map_moments(f, opt_state):
    """Apply ``f`` to the moment buffers of a packed opt state, leaving
    the step count alone."""
    return {k: (v if k == "count" else f(v)) for k, v in opt_state.items()}


def _advance(count, active):
    """count + 1: a shared scalar count always advances; a per-group
    count advances on the active rows only."""
    if active is None or count.dim() == 0:
        return count + 1
    return count + active.to(count.dtype)


def _zero_count(buf):
    return torch.zeros((), dtype=torch.int32, device=buf.device)


def packed_sgd(lr: float, *, impl: str = "auto") -> Optimizer:
    def init(buf):
        return {"count": _zero_count(buf)}

    def step(buf, grads, state, active=None):
        fused_sgd(_rows(buf), _rows(grads), lr=lr, active=active, impl=impl)
        return buf, {"count": _advance(state["count"], active)}

    return Optimizer(init, step, "sgd", packed=True, impl=impl)


def packed_momentum(lr: float, beta: float = 0.9, *,
                    impl: str = "auto") -> Optimizer:
    def init(buf):
        return {"count": _zero_count(buf), "mu": torch.zeros_like(buf)}

    def step(buf, grads, state, active=None):
        fused_momentum(_rows(buf), _rows(grads), _rows(state["mu"]), lr=lr,
                       beta=beta, active=active, impl=impl)
        return buf, {"count": _advance(state["count"], active),
                     "mu": state["mu"]}

    return Optimizer(init, step, "momentum", packed=True, impl=impl,
                     moment_keys=("mu",))


def packed_adamw(lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, *,
                 impl: str = "auto") -> Optimizer:
    def init(buf):
        return {"count": _zero_count(buf), "m": torch.zeros_like(buf),
                "v": torch.zeros_like(buf)}

    def step(buf, grads, state, active=None):
        c = state["count"] + 1    # the bias correction uses the new count
        fused_adamw(_rows(buf), _rows(grads), _rows(state["m"]),
                    _rows(state["v"]), c, lr=lr, b1=b1, b2=b2, eps=eps,
                    wd=weight_decay, active=active, impl=impl)
        return buf, {"count": _advance(state["count"], active),
                     "m": state["m"], "v": state["v"]}

    return Optimizer(init, step, "adamw", packed=True, impl=impl,
                     count_dependent=True, moment_keys=("m", "v"),
                     moment_nonneg=("v",))


_PACKED = {"sgd": packed_sgd, "momentum": packed_momentum,
           "adamw": packed_adamw}


def packed(name: str, lr: float, *, impl: str = "auto", **kw) -> Optimizer:
    """Packed (flat-buffer, fused-kernel) optimizer by name."""
    return _PACKED[name](lr, impl=impl, **kw)


# ---------------------------------------------------------------------------
# Transforms: global-norm clipping and lr schedules
# ---------------------------------------------------------------------------


def clip_by_global_norm(opt: Optimizer, max_norm: float) -> Optimizer:
    """Wrap an optimizer so grads are clipped to a global L2 norm first.

    Packed: one norm per group, over the buffer's last axis (the pytree
    round clips each group on its own). Pytree: one norm over every leaf.
    ``dataclasses.replace`` keeps the packed and impl flags."""

    def scale_of(gn):
        # a true division (a Python scalar over a tensor would take the
        # tensor's reciprocal first)
        return torch.clamp(torch.full_like(gn, max_norm)
                           / torch.clamp(gn, min=1e-12), max=1.0)

    if opt.packed:
        def step(buf, grads, state, active=None):
            gn = torch.sqrt(torch.sum(torch.square(grads.to(torch.float32)),
                                      dim=-1, keepdim=True))
            return opt.step(buf, grads * scale_of(gn).to(grads.dtype), state,
                            active=active)
    else:
        def step(params, grads, state):
            gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                                for g in tree.leaves(grads)))
            scale = scale_of(gn)
            return opt.step(params, tree.tree_map(
                lambda g: g * scale.to(g.dtype), grads), state)

    return dataclasses.replace(opt, step=step, name=opt.name + "+clip")


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    """lr(count): linear warmup then cosine decay to min_frac*base_lr, in
    float32 on the count's device."""

    def lr_fn(count):
        c = torch.as_tensor(count).to(torch.float32)
        warm = base_lr * (c + 1.0) / max(warmup, 1)
        prog = torch.clamp((c - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac)
                         * 0.5 * (1.0 + torch.cos(math.pi * prog)))
        return torch.where(c < warmup, warm, cos)

    return lr_fn


def with_schedule(make_opt: Callable[[float], Optimizer], lr_fn) -> Optimizer:
    """Optimizer whose lr follows lr_fn(state['count']): the unit-lr update
    ``n``, then ``p + lr * (n - p)`` (exact for updates linear in lr:
    sgd, momentum, and adamw's lr-independent direction). A packed
    optimizer updates in place, so its step keeps a copy of the round's
    params; with one count per row, each row takes its own lr."""
    unit = make_opt(1.0)

    if unit.packed:
        def step(buf, grads, state, active=None):
            lr = lr_fn(state["count"])
            if lr.dim() == 1:
                lr = lr[:, None]
            p0 = buf.clone()
            new_b, new_s = unit.step(buf, grads, state, active=active)
            new_b.copy_(p0 + lr * (new_b - p0))
            return new_b, new_s
    else:
        def step(params, grads, state):
            lr = lr_fn(state["count"])
            new_p, new_s = unit.step(params, grads, state)
            return tree.tree_map(lambda n, p: p + lr.to(p.dtype) * (n - p),
                                 new_p, params), new_s

    # a schedule makes the update count-dependent by definition
    return dataclasses.replace(unit, step=step, name=unit.name + "+sched",
                               count_dependent=True)


_TREE = {"sgd": sgd, "momentum": momentum, "adamw": adamw}


def get(name: str, lr: float, *, packed: bool = False, **kw) -> Optimizer:
    table = _PACKED if packed else _TREE
    if name not in table:
        raise ValueError(f"unknown optimizer {name!r} (have {sorted(table)}"
                         f", packed={packed})")
    if not packed and "impl" in kw:
        # the fused kernels exist only on the flat-buffer path
        raise ValueError(
            f"impl={kw['impl']!r} selects the fused-kernel path, which "
            "only exists for packed optimizers — pass packed=True (the "
            "pytree optimizers have no kernel)")
    return table[name](lr, **kw)
