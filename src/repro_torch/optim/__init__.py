"""Packed optimizers (counterpart of ``repro/optim/__init__.py``, the
flat-buffer half: ``packed_sgd``, ``packed_momentum``, ``packed_adamw``).

API: ``opt = packed("adamw", lr)``; ``state = opt.init(buf)``;
``buf, state = opt.step(buf, grads, state, active=None)``.

Params, grads and every moment are (G, N) float32 buffers, and each step
is one fused kernel launch over the whole buffer. The updates are IN
PLACE: ``step`` overwrites ``buf`` and the moment buffers of ``state``
(the reference gets the same effect from buffer donation under jit) and
returns them together with the advanced step count. ``active`` is an
optional (G,) bool mask: rows that are not active keep their params and
moments, and a per-row count advances only where the row is active (the
local round's t_i mask).

The pytree optimizers, ``clip_by_global_norm`` and the lr schedules are
not ported yet (ROADMAP.md Queue A, ``optim/__init__.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from repro_torch.kernels.fused_adamw import fused_adamw
from repro_torch.kernels.fused_momentum import fused_momentum
from repro_torch.kernels.fused_sgd import fused_sgd


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    step: Callable
    name: str = "opt"
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
        fused_sgd(buf, grads, lr=lr, active=active, impl=impl)
        return buf, {"count": _advance(state["count"], active)}

    return Optimizer(init, step, "sgd", impl=impl)


def packed_momentum(lr: float, beta: float = 0.9, *,
                    impl: str = "auto") -> Optimizer:
    def init(buf):
        return {"count": _zero_count(buf), "mu": torch.zeros_like(buf)}

    def step(buf, grads, state, active=None):
        fused_momentum(buf, grads, state["mu"], lr=lr, beta=beta,
                       active=active, impl=impl)
        return buf, {"count": _advance(state["count"], active),
                     "mu": state["mu"]}

    return Optimizer(init, step, "momentum", impl=impl, moment_keys=("mu",))


def packed_adamw(lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, *,
                 impl: str = "auto") -> Optimizer:
    def init(buf):
        return {"count": _zero_count(buf), "m": torch.zeros_like(buf),
                "v": torch.zeros_like(buf)}

    def step(buf, grads, state, active=None):
        c = state["count"] + 1    # the bias correction uses the new count
        fused_adamw(buf, grads, state["m"], state["v"], c, lr=lr, b1=b1,
                    b2=b2, eps=eps, wd=weight_decay, active=active, impl=impl)
        return buf, {"count": _advance(state["count"], active),
                     "m": state["m"], "v": state["v"]}

    return Optimizer(init, step, "adamw", impl=impl, count_dependent=True,
                     moment_keys=("m", "v"), moment_nonneg=("v",))


_PACKED = {"sgd": packed_sgd, "momentum": packed_momentum,
           "adamw": packed_adamw}


def packed(name: str, lr: float, *, impl: str = "auto", **kw) -> Optimizer:
    """Packed (flat-buffer, fused-kernel) optimizer by name."""
    return _PACKED[name](lr, impl=impl, **kw)


def get(name: str, lr: float, *, packed: bool = False, **kw) -> Optimizer:
    if not packed:
        raise NotImplementedError(
            "only the packed optimizers are ported (pass packed=True); the "
            "pytree ones follow with the pytree round (ROADMAP.md Queue A, "
            "optim/__init__.py)")
    if name not in _PACKED:
        raise ValueError(f"unknown optimizer {name!r} (have {sorted(_PACKED)})")
    return _PACKED[name](lr, **kw)
