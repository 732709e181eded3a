"""Mixture-of-Experts layer (counterpart of ``repro/models/moe.py``).

Two implementations selected by ``cfg.moe_impl``:

* ``densemask`` (both moe configs' default): every expert processes
  every token and the top-k gates weight the sum over the experts. A
  token's output depends on that token alone.
* ``dispatch``: capacity-based top-k dispatch. Tokens are scattered into
  an (E, C, D) buffer, each expert runs one product over its capacity
  slice, and the outputs are gathered back and weighted by the gates.
  Entries past an expert's capacity are dropped (their scale is 0), so a
  token's output depends on the other tokens of the batch, as in the
  reference.

Experts are stacked on a leading axis. The router returns a
Switch-style load-balance loss (``aux``), which ``Model.loss`` adds at
0.01.

``jax.lax.top_k`` breaks ties toward the lower expert index; the router
here takes the first k of a stable descending sort, which does the same.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import pdef


def moe_defs(cfg):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    defs = {"w_router": pdef((d, e), ("embed", None))}
    if cfg.mlp_type == "swiglu":
        defs.update({
            "w_gate": pdef((e, d, f), ("experts", "embed", "ff")),
            "w_up": pdef((e, d, f), ("experts", "embed", "ff")),
            "w_down": pdef((e, f, d), ("experts", "ff", "embed")),
        })
    else:
        defs.update({
            "w_up": pdef((e, d, f), ("experts", "embed", "ff")),
            "w_down": pdef((e, f, d), ("experts", "ff", "embed")),
        })
    return defs


def _act(cfg, u):
    """The non-gated activations of ``mlp_type`` relu2 and gelu."""
    return torch.square(F.relu(u)) if cfg.mlp_type == "relu2" \
        else F.gelu(u, approximate="tanh")


def top_k(probs, k: int):
    """(values, indices) of the k largest entries on the last axis, ties
    to the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router(p, x, cfg):
    """Returns (top-k gates (B,S,k) in x.dtype, top-k indices (B,S,k)
    int64, aux loss)."""
    logits = torch.einsum("bsd,de->bse", x, p["w_router"].to(x.dtype))
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gates, idx = top_k(probs, cfg.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    E = cfg.n_experts
    me = probs.reshape(-1, E).mean(0)
    one_hot = F.one_hot(idx.reshape(-1, cfg.top_k), E).to(torch.float32)
    ce = one_hot.sum(1).mean(0) / cfg.top_k
    aux = E * torch.sum(me * ce)
    return gates.to(x.dtype), idx, aux


def _all_experts(p, x, cfg):
    """Every expert's FFN on every token of x (B,S,D): (E,B,S,D), the
    experts batched into one product a matrix."""
    dt = x.dtype
    if cfg.mlp_type == "swiglu":
        h = F.silu(torch.einsum("bsd,edf->ebsf", x, p["w_gate"].to(dt))) * \
            torch.einsum("bsd,edf->ebsf", x, p["w_up"].to(dt))
    else:
        h = _act(cfg, torch.einsum("bsd,edf->ebsf", x, p["w_up"].to(dt)))
    return torch.einsum("ebsf,efd->ebsd", h, p["w_down"].to(dt))


def moe_densemask(p, x, cfg):
    """Every expert sees every token; the gates weight the sum over the
    experts. The reference loops over the experts; here each matrix is
    one product over all of them, and the weighted sum one contraction
    over the expert axis (a token's output still depends on that token
    alone)."""
    gates, idx, aux = router(p, x, cfg)
    combine = torch.zeros(x.shape[:2] + (cfg.n_experts,), dtype=x.dtype,
                          device=x.device).scatter_add(-1, idx, gates)
    out = torch.einsum("bse,ebsd->bsd", combine, _all_experts(p, x, cfg))
    return out, aux


def capacity(tokens: int, cfg, capacity_factor: float = 1.25) -> int:
    """Slots an expert takes under dispatch: int(K*T*cf/E), rounded up to
    a multiple of 128 above 128 (the reference's rule)."""
    C = max(int(cfg.top_k * tokens * capacity_factor / cfg.n_experts), 1)
    return ((C + 127) // 128) * 128 if C > 128 else C


def moe_dispatch(p, x, cfg, capacity_factor: float = 1.25):
    """Capacity-based top-k dispatch; overflow entries are dropped."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    C = capacity(T, cfg, capacity_factor)
    gates, idx, aux = router(p, x, cfg)
    xf, gf, ef = x.reshape(T, D), gates.reshape(T, K), idx.reshape(T, K)

    # each (token, k)'s place in its expert's queue, token-major
    onehot = F.one_hot(ef, E).reshape(T * K, E)
    pos_all = torch.cumsum(onehot, dim=0) - 1
    pos = torch.gather(pos_all.reshape(T, K, E), -1, ef[..., None])[..., 0]
    keep = pos < C
    safe_pos = torch.where(keep, pos, C - 1)
    scale = keep.to(x.dtype)

    disp = torch.zeros((E, C, D), dtype=x.dtype, device=x.device)
    for k in range(K):
        disp = disp.index_put((ef[:, k], safe_pos[:, k]),
                              xf * scale[:, k, None], accumulate=True)
    dt = x.dtype
    if cfg.mlp_type == "swiglu":
        g = torch.einsum("ecd,edf->ecf", disp, p["w_gate"].to(dt))
        u = torch.einsum("ecd,edf->ecf", disp, p["w_up"].to(dt))
        h = F.silu(g) * u
    else:
        h = _act(cfg, torch.einsum("ecd,edf->ecf", disp, p["w_up"].to(dt)))
    eout = torch.einsum("ecf,efd->ecd", h, p["w_down"].to(dt))

    out = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for k in range(K):
        contrib = eout[ef[:, k], safe_pos[:, k]]
        out = out + contrib * (gf[:, k] * scale[:, k])[:, None]
    return out.reshape(B, S, D), aux


def moe_forward(p, x, cfg):
    if cfg.moe_impl == "dispatch":
        return moe_dispatch(p, x, cfg)
    return moe_densemask(p, x, cfg)


def moe_decode(p, x, cfg):
    """One token a slot, x (B,1,D): each slot's k chosen experts applied
    with their own weights, gathered per slot. The gathered weights of
    one matrix and one k are made, used and freed before the next, so at
    most one (B, D, F) copy is held."""
    gates, idx, aux = router(p, x, cfg)            # (B,1,K)
    dt = x.dtype
    xe = x[:, 0]                                   # (B,D)

    def mat(name, e, spec, a):
        return torch.einsum(spec, a, p[name][e].to(dt))

    out = torch.zeros_like(xe)
    for k in range(cfg.top_k):
        e = idx[:, 0, k]
        if cfg.mlp_type == "swiglu":
            h = F.silu(mat("w_gate", e, "bd,bdf->bf", xe)) * \
                mat("w_up", e, "bd,bdf->bf", xe)
        else:
            h = _act(cfg, mat("w_up", e, "bd,bdf->bf", xe))
        out = out + gates[:, 0, k, None] * mat("w_down", e, "bf,bfd->bd", h)
    return out[:, None], aux
