"""The paper's Alg 1 as a packed local-SGD round (counterpart of
``repro/core/localsgd.py``, ``_make_packed_local_round``; DESIGN.md §6).

    worker i:  pull x_n; run T_i local GD steps; push the result
    server:    x_{n+1} = (1/m) sum_i x_n^{i,T_i}

The state is one (G, N) float32 buffer per stream (params plus the
optimizer's moments). Each local step takes every group's gradient
against its own row, then updates all G*N elements with one fused kernel
launch. The round ends with one exchange of every stream over G through
the exchange's topology and codecs (server/fp32 by default; DESIGN.md
§8, §10) and the reference's observability block.

The round takes ownership of ``state_G``: its buffers are updated in
place (the reference donates them to its jitted round) and returned in
the new state. So a lossy stream, whose codec encodes the round delta
``x_T - x_0``, gets a copy of its round-start value before the local
steps (one (G, N) buffer per lossy stream); fp32 streams are not copied.
An exchange that carries state between rounds (codec counters and
residuals, staleness buffers, downlink references) keeps it in the train
state under ``"comm"`` (``init_state(..., exchange=...)``).

Per-group gradients come from a Python loop over G: row g is unpacked
into detached views that require grad, ``torch.autograd.grad`` runs on
group g's batch, and the leaf gradients are copied into row g of one
(G, N) gradient buffer.

Not ported yet (ROADMAP.md Queue A, core/localsgd.py): the pytree round,
threshold (T_i = inf) mode, microbatch inner mode, ``make_sync_step``
and sharded execution.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch import comm as comm_mod
from repro_torch import tree
from repro_torch.kernels.sq_norm import sq_norm_groups
from repro_torch.optim import Optimizer, packing


@dataclasses.dataclass(frozen=True)
class LocalSGDConfig:
    n_groups: int                 # m in the paper
    inner_steps: int = 1          # T (uniform), or max T when t_i is set
    # per-node T_i (paper Alg 1): group g runs t_i[g] <= inner_steps steps
    t_i: Optional[Tuple[int, ...]] = None
    threshold: Optional[float] = None   # T_i = inf mode (not ported)
    # "final": loss and ||grad||^2 once at the round's result (the hot
    # path); "traj": per-step trajectories, with one norm per step
    metrics: str = "final"


def average_groups(params_G):
    """Model averaging: mean over the leading G axis, broadcast back."""
    return tree.tree_map(
        lambda x: x.mean(dim=0, keepdim=True).expand_as(x), params_G)


def grad_sq_norm(leaf_grads) -> torch.Tensor:
    """||g||^2 of per-leaf gradients: one partial sum per leaf, added in
    the tree's leaf order."""
    return sum(torch.sum(torch.square(g.to(torch.float32)))
               for g in leaf_grads)


def _consensus_sq_flat(x_G, impl: str) -> torch.Tensor:
    """Per-group consensus distance ||x_g - mean||^2 of a (G, N) buffer
    -> (G,), reduced by the sq_norm_groups kernel."""
    x32 = x_G.to(torch.float32)
    return sq_norm_groups(x32 - x32.mean(dim=0, keepdim=True), impl=impl)


def _round_wire_bytes(exch, layout, moment_keys) -> dict:
    """Exact payload bytes of one round (static: shapes only)."""
    n = layout.padded
    sizes = {k: n for k in moment_keys}
    by_stream = exch.wire_bytes_by_stream(n, sizes)
    by_tier = exch.wire_bytes_by_tier(n, sizes)
    out = {"wire_bytes": sum(by_stream.values()),
           "wire_bytes_up": exch.wire_bytes_up(n, moment_sizes=sizes),
           "wire_bytes_down": exch.wire_bytes_down(n, moment_sizes=sizes),
           "wire_bytes_intra": by_tier["intra"],
           "wire_bytes_inter": by_tier["inter"]}
    out.update({f"wire_bytes/{k}": v for k, v in by_stream.items()})
    return out


def _check_comm_state(exch, state_G, mkeys=()) -> None:
    if exch.stateful and "comm" not in state_G:
        raise ValueError(
            f"exchange {exch.name!r} carries round-to-round state "
            "(staleness buffers / codec residuals); build the train state "
            "with init_state(..., exchange=...)")
    if (exch.topology == "async_stale" and mkeys
            and "pushed_opt" not in state_G.get("comm", {})):
        raise ValueError(
            "async_stale averages opt state through per-stream staleness "
            "buffers; build the train state with init_state(..., "
            "exchange=...) so comm['pushed_opt'] is allocated "
            "(DESIGN.md §10)")


def _clamp_nonneg_streams(mixed: dict, opt, exch) -> dict:
    """Project lossy-decoded non-negative moment streams (adamw's v) back
    onto [0, inf), in place: a delta codec's decode error is bounded by
    the chunk scale, so a small v element can come back slightly
    negative, and sqrt(v) would be NaN. Identity moment codecs without a
    lossy downlink skip this (the default path stays bit-exact)."""
    if ((exch.mcodec.identity and not exch.lossy_downlink)
            or exch.topology == "none"):
        return mixed
    for k in opt.moment_nonneg:
        if k in mixed:
            mixed[k].clamp_(min=0.0)
    return mixed


def _residual_sq_groups(res, n_groups: int, device, impl: str):
    """Per-group squared mass of a codec's error-feedback residual ->
    (G,), reduced by the sq_norm_groups kernel; zeros when the stream's
    codec carries none."""
    if res is None:
        return torch.zeros((n_groups,), dtype=torch.float32, device=device)
    return sq_norm_groups(res, impl=impl)


def _obs_round_metrics(exch, comm_state: dict, streams, consensus_pre,
                       consensus_post, n_groups: int, device,
                       impl: str) -> dict:
    """The reference's uniform per-round block (DESIGN.md §13) on a
    reliable single-tier exchange: consensus before and after, each
    stream's codec error (its error-feedback residual), no backlog, full
    participation and delivery."""
    one = torch.ones((), dtype=torch.float32, device=device)
    m = {"consensus_sq": consensus_pre, "consensus_sq_post": consensus_post}
    cstates = comm_state.get("codec", {})
    for s in streams:
        m[f"codec_err/{s}"] = _residual_sq_groups(
            cstates.get(s, {}).get("residual"), n_groups, device, impl)
    m["backlog_mass"] = torch.zeros((), dtype=torch.float32, device=device)
    rate = torch.tensor(exch.delivery_rate, dtype=torch.float32,
                        device=device)
    m.update(participation=one, delivery_rate=rate, participation_intra=one,
             participation_inter=one, delivery_rate_intra=rate,
             delivery_rate_inter=one)
    return m


def make_local_round(loss_fn: Callable, opt: Optimizer, cfg: LocalSGDConfig,
                     layout: Optional[packing.Layout] = None,
                     exchange: Optional[comm_mod.Exchange] = None,
                     shardexec=None):
    """Build ``round(state_G, batch_G) -> (state_G, metrics)``.

    loss_fn(params, batch) -> scalar tensor. state_G: {"params": (G, N),
    "opt": packed opt state}, plus "comm" when the exchange carries state.
    batch_G: dict of tensors with a leading G axis. Needs ``layout`` (the
    packed round; the optimizers of ``repro_torch.optim`` are all packed).
    ``opt.impl`` selects the update and norm kernels: on a CUDA state
    "auto" launches them; the exchange's codecs dispatch on the device
    the same way. Every moment stream is exchanged with the params, each
    through the exchange's moment codec, as in the reference's default."""
    if layout is None:
        raise NotImplementedError(
            "only the packed round is ported: pass layout= (the pytree "
            "round is ROADMAP.md Queue A, core/localsgd.py)")
    if shardexec is not None:
        raise NotImplementedError(
            "sharded execution is not ported yet (ROADMAP.md Queue A, "
            "sharding/shardexec.py -> torch.distributed)")
    if cfg.threshold is not None:
        raise NotImplementedError(
            "threshold (T_i=inf) mode is not ported yet (ROADMAP.md Queue "
            "A, core/localsgd.py)")
    if cfg.metrics not in ("traj", "final"):
        raise ValueError(f"metrics={cfg.metrics!r} (have 'traj', 'final')")
    exch = exchange if exchange is not None else comm_mod.default_exchange(
        cfg.n_groups)
    if exch.n_groups != cfg.n_groups:
        raise ValueError(f"exchange built for G={exch.n_groups} but "
                         f"cfg.n_groups={cfg.n_groups}")
    packing.check_packed_index_space(layout, cfg.n_groups)
    if cfg.t_i is not None and (len(cfg.t_i) != cfg.n_groups
                                or max(cfg.t_i) > cfg.inner_steps):
        raise ValueError(f"t_i={cfg.t_i} needs {cfg.n_groups} entries, each "
                         f"<= inner_steps={cfg.inner_steps}")
    per_group_count = cfg.t_i is not None and opt.count_dependent
    mkeys = packing.stream_layout_for(opt, layout).moment_streams
    flat_vg = packing.value_and_flat_grad(loss_fn, layout)
    traj = cfg.metrics == "traj"
    G, T = cfg.n_groups, cfg.inner_steps

    def round_(state_G, batch_G):
        _check_comm_state(exch, state_G, mkeys)
        comm_state = state_G.get("comm", {})
        params = state_G["params"]
        dev = params.device
        opt_state = dict(state_G["opt"])
        # the round start of every lossy stream (the buffers are updated
        # in place below); fp32 streams are never copied
        xs0 = {k: (params if k == "params" else opt_state[k]).clone()
               for k in ("params",) + tuple(mkeys) if exch.lossy_stream(k)}
        if per_group_count and opt_state["count"].dim() == 0:
            # first round after init: the shared count becomes one per group
            opt_state["count"] = opt_state["count"].expand(G).clone()
        batches = [tree.tree_map(lambda x: x[g], batch_G) for g in range(G)]
        # (T, G) step mask of the t_i schedule, made once per round
        active = (None if cfg.t_i is None else
                  (torch.arange(T)[:, None]
                   < torch.tensor(cfg.t_i)[None, :]).to(dev))
        grads = torch.empty_like(params)
        losses, gsqs = [], []
        for t in range(T):
            loss_t = torch.stack([flat_vg(params[g], batches[g],
                                          out=grads[g])[0] for g in range(G)])
            params, opt_state = opt.step(
                params, grads, opt_state,
                active=None if active is None else active[t])
            if traj:
                losses.append(loss_t)
                gsqs.append(sq_norm_groups(grads, impl=opt.impl))
        del grads

        n_steps = torch.tensor(cfg.t_i if cfg.t_i is not None else [T] * G,
                               dtype=torch.int32, device=dev)
        if traj:
            gsq_traj = torch.stack(gsqs, dim=1)               # (G, T)
            metrics = {"loss": losses[-1], "inner_steps": n_steps,
                       "grad_sq": gsq_traj[:, -1],
                       "grad_sq_first": gsq_traj[:, 0],
                       "grad_sq_traj": gsq_traj}
        else:
            # one extra loss/grad at the round's result; its norm is the
            # per-leaf sum (no packed gradient needed)
            loss_G, gsq_G = [], []
            for g in range(G):
                loss, leaf_grads = packing.value_and_leaf_grads(
                    loss_fn, layout, params[g], batches[g])
                loss_G.append(loss)
                gsq_G.append(grad_sq_norm(leaf_grads))
            metrics = {"loss": torch.stack(loss_G), "inner_steps": n_steps,
                       "grad_sq": torch.stack(gsq_G)}

        consensus_pre = _consensus_sq_flat(params, opt.impl)
        # every stream (params and moments) through the exchange; the
        # step count is never exchanged
        mixed, comm_state = exch.streams(
            {"params": params, **{k: opt_state[k] for k in mkeys}}, xs0,
            comm_state)
        del xs0
        mixed = _clamp_nonneg_streams(mixed, opt, exch)
        params = mixed["params"]
        opt_state.update({k: mixed[k] for k in mkeys})
        metrics.update(_round_wire_bytes(exch, layout, mkeys))
        metrics.update(_obs_round_metrics(
            exch, comm_state, ("params",) + tuple(mkeys), consensus_pre,
            _consensus_sq_flat(params, opt.impl), G, dev, opt.impl))
        out = {"params": params, "opt": opt_state}
        if "comm" in state_G:
            out["comm"] = comm_state
        return out, metrics

    return round_


def init_state(params, opt: Optimizer, n_groups: int,
               layout: packing.Layout,
               exchange: Optional[comm_mod.Exchange] = None):
    """Packed grouped state: the params tree packed to (N,) and copied to
    every one of the ``n_groups`` rows, plus the optimizer's state, plus
    (for an exchange that carries state between rounds) the exchange's
    state for the params and every moment stream under ``"comm"``."""
    buf_G = packing.pack(params, layout)[None].repeat(n_groups, 1)
    state = {"params": buf_G, "opt": opt.init(buf_G)}
    if exchange is not None and exchange.stateful:
        moments = {k: state["opt"][k] for k in opt.moment_keys}
        state["comm"] = exchange.init(buf_G, moments=moments or None)
    return state


def server_params(state_G, layout: packing.Layout):
    """The averaged (server) model of a grouped state, as a tree."""
    buf = state_G["params"]
    if buf.dim() > 1:
        buf = buf.mean(dim=0)
    return packing.unpack(buf, layout)

