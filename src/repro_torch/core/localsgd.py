"""The paper's Alg 1 as local-SGD rounds (counterpart of
``repro/core/localsgd.py``; DESIGN.md §6).

    worker i:  pull x_n; run T_i local GD steps (or until ||grad||^2 <= eps,
               the paper's "Threshold" / T_i = infinity mode); push result
    server:    x_{n+1} = (1/m) sum_i x_n^{i,T_i}

Two rounds, as in the reference, and the conventional baseline:

* The packed round (``layout=`` and a packed optimizer): the state is one
  (G, N) float32 buffer per stream (params plus the optimizer's moments).
  Each local step takes every group's gradient against its own row, then
  updates all G*N elements with one fused kernel launch. The round ends
  with one exchange of every stream over G through the exchange's
  topology and codecs (DESIGN.md §8, §10). It takes ownership of
  ``state_G``: its buffers are updated in place (the reference donates
  them to its jitted round) and returned in the new state, so a lossy
  stream, whose codec encodes the round delta ``x_T - x_0``, gets a copy
  of its round-start value before the local steps; fp32 streams are not
  copied. An exchange that carries state between rounds keeps it under
  ``"comm"`` (``init_state(..., exchange=...)``).
* The pytree round (no layout, a pytree optimizer): every state leaf has
  a leading G axis. It adds the threshold (T_i = inf) mode, which the
  packed round refuses as the reference's does. Its exchange runs every
  stream leaf by leaf through the staged path, as the reference's does
  (the cast codecs, the downlink, async_stale, fault plans, push_sum and
  the tiers). It launches no kernel: the pytree optimizers have none,
  and a tree stream never reaches the fused exchange. It leaves its
  caller's state as it was (the lossy streams' round start is the
  caller's leaves, read only).
* ``make_sync_step``: synchronous data parallelism, one step on the
  global batch (packed: one fused update and one ``sq_norm`` launch).

Per-group work is a Python loop over G. The packed round unpacks row g
into detached views that require grad, runs ``torch.autograd.grad`` on
group g's batch and copies the leaf gradients into row g of one (G, N)
gradient buffer. The pytree round runs each group's local steps on its
own; a threshold group reads its stopping test after every step and
stops on its own, which gives the counts of the reference's vmapped
``while_loop`` (finished groups keep their state there).

With an overlapped exchange the packed round mixes the previous round's
in-flight payload before its local steps and puts its own result in
flight (DESIGN.md §14); the pytree round refuses overlap and the
flat-only codecs (int8, int8z, top-k), as the reference's does.

Sharded execution (``shardexec=``, a ``sharding.ShardExec``; DESIGN.md
§9): the packed round on G * S ranks, rank ``g * S + s`` holding the
(1, Np / S) block of group g's buffers on a ``packing.ShardedLayout``
(``init_state(..., shardexec=)`` builds it). Each local step gathers the
group's params over the shard subgroup, takes the loss and gradient on
the group's whole batch (the reference's in-group batch is replicated)
and keeps its own shard of the packed gradient; the fused update, the
norms and the exchange run on the block (``shardexec.py``). The metrics
are the unsharded round's (G,) vectors on every rank, and so are the
wire bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch import comm as comm_mod
from repro_torch import tree
from repro_torch.kernels.sq_norm import sq_norm, sq_norm_groups
from repro_torch.optim import Optimizer, packing


@dataclasses.dataclass(frozen=True)
class LocalSGDConfig:
    n_groups: int                 # m in the paper
    inner_steps: int = 1          # T (uniform), or max T when t_i is set
    # per-node T_i (paper Alg 1): group g runs t_i[g] <= inner_steps steps
    t_i: Optional[Tuple[int, ...]] = None
    threshold: Optional[float] = None  # if set: T_i = inf mode, stop at
                                       # ||grad_i||^2 <= threshold
    max_inner: int = 1_000        # hard cap for threshold mode
    inner_mode: str = "fixed_batch"    # fixed_batch (paper GD) | microbatch
    average_opt_state: bool = True
    # packed round only: "final" evaluates loss and ||grad||^2 once at the
    # round's result (the hot path); "traj" records them at every step.
    # The pytree round always records trajectories.
    metrics: str = "final"


class TrainState(dict):
    """{"params": tree, "opt": tree} — a plain dict."""


def replicate(tree_, n_groups: int):
    """A tree with a leading group axis, every group a copy of ``tree_``
    (materialized: the rounds mix the groups in place)."""
    return tree.tree_map(
        lambda x: x.unsqueeze(0).repeat(n_groups, *([1] * x.dim())), tree_)


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


def _consensus_sq_tree(params_G) -> torch.Tensor:
    """Per-group ||x_g - mean||^2 summed over every leaf -> (G,)."""
    total = None
    for leaf in tree.leaves(params_G):
        x = leaf.to(torch.float32)
        d = x - x.mean(dim=0, keepdim=True)
        part = torch.sum(torch.square(d), dim=tuple(range(1, d.dim())))
        total = part if total is None else total + part
    return total


def _round_wire_bytes(exch, n: int, moment_sizes: dict) -> dict:
    """Exact payload bytes of one round (static: shapes only): the params'
    ``n`` elements and each moment stream's, each through its codec."""
    by_stream = exch.wire_bytes_by_stream(n, moment_sizes)
    by_tier = exch.wire_bytes_by_tier(n, moment_sizes)
    out = {"wire_bytes": sum(by_stream.values()),
           "wire_bytes_up": exch.wire_bytes_up(n, moment_sizes=moment_sizes),
           "wire_bytes_down": exch.wire_bytes_down(
               n, moment_sizes=moment_sizes),
           "wire_bytes_intra": by_tier["intra"],
           "wire_bytes_inter": by_tier["inter"]}
    out.update({f"wire_bytes/{k}": v for k, v in by_stream.items()})
    return out


def _check_comm_state(exch, state_G, mkeys=()) -> None:
    comm_state = state_G.get("comm", {})
    if exch.stateful and "comm" not in state_G:
        raise ValueError(
            f"exchange {exch.name!r} carries round-to-round state "
            "(staleness buffers / codec residuals); build the train state "
            "with init_state(..., exchange=...)")
    if (exch.topology == "async_stale" and mkeys
            and "pushed_opt" not in comm_state):
        raise ValueError(
            "async_stale averages opt state through per-stream staleness "
            "buffers; build the train state with init_state(..., "
            "exchange=...) so comm['pushed_opt'] is allocated "
            "(DESIGN.md §10)")
    if exch.topology == "push_sum" and "mass" not in comm_state:
        raise ValueError(
            "push_sum is ratio consensus: every round needs the mass "
            "counters and per-edge backlog buffers; build the train state "
            "with init_state(..., exchange=...) so comm['mass'] / "
            "comm['backlog'] are allocated (DESIGN.md §12)")
    if (exch.faulty and exch.topology == "server"
            and "pushed" not in comm_state):
        raise ValueError(
            "a faulty server exchange retries dropped pushes from "
            "per-group staleness buffers; build the train state with "
            "init_state(..., exchange=...) so comm['pushed'] is "
            "allocated (DESIGN.md §12)")
    if (exch.hierarchical and exch.inter_topology == "push_sum"
            and exch.n_pods > 1 and "mass" not in comm_state):
        raise ValueError(
            "hierarchical push_sum inter tier is ratio consensus: every "
            "round needs the pod-level mass counters and per-edge "
            "backlogs; build the train state with init_state(..., "
            "exchange=...) so comm['mass'] / comm['backlog'] are "
            "allocated (DESIGN.md §16)")
    if exch.overlap and "inflight" not in comm_state:
        raise ValueError(
            "an overlapped exchange double-buffers the previous round's "
            "payload; build the train state with init_state(..., "
            "exchange=...) so comm['inflight'] is allocated "
            "(DESIGN.md §14)")


def _clamp_nonneg_streams(mixed: dict, opt, exch) -> dict:
    """Project lossy-decoded non-negative moment streams (adamw's v) back
    onto [0, inf), in place: a delta codec's decode error is bounded by
    the chunk scale, so a small v element can come back slightly
    negative, and sqrt(v) would be NaN. Overlap always projects: its
    correction ``v + mix(inflight) - inflight`` is additive. Identity
    moment codecs without a lossy downlink or overlap skip this (the
    default path stays bit-exact)."""
    if ((exch.mcodec.identity and not exch.lossy_downlink
         and not exch.overlap) or exch.topology == "none"):
        return mixed
    for k in opt.moment_nonneg:
        if k in mixed:
            tree.tree_map(lambda x: x.clamp_(min=0.0), mixed[k])
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
                       impl: str, sq_groups=None) -> dict:
    """The reference's uniform per-round block (DESIGN.md §13): consensus
    before and after, each stream's codec error (its error-feedback
    residual), push-sum's queued weight mass, participation (overall and
    per tier) and the exchange's expected delivery rates. Always the same
    keys: ones and zeros where a quantity is inert (a flat topology is one
    tier, the whole wire "intra"). ``sq_groups`` reduces a residual to
    (G,) (default: the ``sq_norm_groups`` kernel on the whole buffer)."""
    def dev(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    m = {"consensus_sq": consensus_pre, "consensus_sq_post": consensus_post}
    cstates = comm_state.get("codec", {})
    for s in streams:
        res = cstates.get(s, {}).get("residual")
        m[f"codec_err/{s}"] = (
            _residual_sq_groups(res, n_groups, device, impl)
            if sq_groups is None or res is None else sq_groups(res))
    m["backlog_mass"] = (dev(comm_state["backlog_w"].sum())
                         if "backlog_w" in comm_state else dev(0.0))
    m["participation"] = dev(comm_state.get("participation", 1.0))
    m["delivery_rate"] = dev(exch.delivery_rate)
    m["participation_intra"] = (dev(comm_state["participation_intra"])
                                if "participation_intra" in comm_state
                                else m["participation"])
    m["participation_inter"] = dev(comm_state.get("participation_inter",
                                                  1.0))
    m["delivery_rate_intra"] = dev(exch.delivery_rate_intra)
    m["delivery_rate_inter"] = dev(exch.delivery_rate_inter)
    return m


def _check_cfg(cfg: LocalSGDConfig) -> None:
    if cfg.inner_mode not in ("fixed_batch", "microbatch"):
        raise ValueError(f"inner_mode={cfg.inner_mode!r} (have "
                         "'fixed_batch', 'microbatch')")
    if cfg.t_i is not None and (len(cfg.t_i) != cfg.n_groups
                                or max(cfg.t_i) > cfg.inner_steps):
        raise ValueError(f"t_i={cfg.t_i} needs {cfg.n_groups} entries, each "
                         f"<= inner_steps={cfg.inner_steps}")


def make_local_round(loss_fn: Callable, opt: Optimizer, cfg: LocalSGDConfig,
                     layout: Optional[packing.Layout] = None,
                     exchange: Optional[comm_mod.Exchange] = None,
                     shardexec=None):
    """Build ``round(state_G, batch_G) -> (state_G, metrics)``.

    loss_fn(params, batch) -> scalar tensor. state_G: {"params","opt"}
    with a leading G axis ((G, N) buffers on the packed round), plus
    "comm" when the exchange carries state. batch_G: dict of tensors with
    leading axes (G, ...), or (G, T, ...) in microbatch mode.

    With ``layout`` and a packed optimizer the round is the packed one:
    ``opt.impl`` selects the update and norm kernels (on a CUDA state
    "auto" launches them; the exchange's codecs dispatch on the device
    the same way). With ``shardexec`` too (a ``sharding.ShardExec`` and a
    ``packing.ShardedLayout``), the packed round on this rank's block.
    Without a layout, the pytree round. ``exchange`` defaults to
    server/fp32."""
    _check_cfg(cfg)
    exch = exchange if exchange is not None else comm_mod.default_exchange(
        cfg.n_groups)
    if exch.n_groups != cfg.n_groups:
        raise ValueError(f"exchange built for G={exch.n_groups} but "
                         f"cfg.n_groups={cfg.n_groups}")
    if layout is not None or opt.packed:
        if layout is None or not opt.packed:
            raise ValueError(
                "packed rounds need BOTH a packing.Layout and a packed "
                "optimizer (optim.packed / optim.get(..., packed=True))")
        if shardexec is not None:
            return _make_sharded_round(loss_fn, opt, cfg, layout, exch,
                                       shardexec)
        return _make_packed_local_round(loss_fn, opt, cfg, layout, exch)
    if shardexec is not None:
        raise ValueError(
            "shardexec shards the packed flat buffer — it has no meaning "
            "for the per-leaf pytree round; pass layout= and a packed "
            "optimizer (DESIGN.md §9)")
    return _make_tree_local_round(loss_fn, opt, cfg, exch)


# ---------------------------------------------------------------------------
# The pytree round
# ---------------------------------------------------------------------------


def _value_and_grad(loss_fn):
    """(params, batch) -> (loss, grads tree) by autograd on detached
    copies of the leaves."""
    def vg(params, batch):
        paths, leaves = tree.flatten(params)
        leaves = [x.detach().requires_grad_() for x in leaves]
        with torch.enable_grad():
            loss = loss_fn(tree.unflatten(paths, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree.unflatten(paths, list(grads))

    return vg


def _stack(trees):
    return tree.tree_map(lambda *xs: torch.stack(xs), *trees)


def _make_tree_local_round(loss_fn, opt, cfg, exch):
    exch.check_tree(cfg.average_opt_state)
    vg = _value_and_grad(loss_fn)
    G, T = cfg.n_groups, cfg.inner_steps

    def gsq_of(grads):
        return grad_sq_norm(tree.leaves(grads))

    def threshold_group(p, o, batch):
        """Local steps until the gradient the last step used has
        ||g||^2 <= threshold (or max_inner steps): the reference's loop
        tests the norm its body took BEFORE the step, from |g(w0)|^2, so a
        start at or below eps takes no step, and otherwise the group
        stops after the step from the first w_k with |g(w_k)|^2 <= eps.
        loss and grad_sq are those of that last w_k."""
        loss, g = vg(p, batch)
        gsq, t = gsq_of(g), 0
        while t < cfg.max_inner and bool(gsq > cfg.threshold):
            if t:
                loss, g = vg(p, batch)
                gsq = gsq_of(g)
            p, o = opt.step(p, g, o)
            t += 1
        return p, o, {"loss": loss, "inner_steps": t, "grad_sq": gsq}

    def steps_group(p, o, batches, t_i):
        """T steps, step t on ``batches(t)``; steps t >= t_i leave the
        state as it is (the reference's masked scan), and their loss and
        norm, taken at that frozen state, repeat."""
        losses, gsqs = [], []
        for t in range(T):
            if t > t_i:
                losses.append(losses[-1])
                gsqs.append(gsqs[-1])
                continue
            loss, g = vg(p, batches(t))
            losses.append(loss)
            gsqs.append(gsq_of(g))
            if t < t_i:
                p, o = opt.step(p, g, o)
        gsq = torch.stack(gsqs)
        return p, o, {"loss": losses[-1], "inner_steps": t_i,
                      "grad_sq": gsq[-1], "grad_sq_first": gsq[0],
                      "grad_sq_traj": gsq}

    def round_(state_G, batch_G):
        mkeys = (tuple(k for k in state_G["opt"] if k != "count")
                 if cfg.average_opt_state else ())
        _check_comm_state(exch, state_G, mkeys)
        comm_state = state_G.get("comm", {})
        params_G, opt_G = state_G["params"], state_G["opt"]
        dev = tree.leaves(params_G)[0].device
        outs = []
        for g in range(G):
            p = tree.tree_map(lambda x: x[g], params_G)
            o = tree.tree_map(lambda x: x[g], opt_G)
            b = tree.tree_map(lambda x: x[g], batch_G)
            if cfg.inner_mode == "microbatch":
                # one microbatch a step; t_i does not apply (as in the
                # reference, which ignores it in this mode)
                outs.append(steps_group(
                    p, o, lambda t: tree.tree_map(lambda x: x[t], b), T))
            elif cfg.threshold is not None:
                outs.append(threshold_group(p, o, b))
            else:
                outs.append(steps_group(
                    p, o, lambda t: b,
                    T if cfg.t_i is None else cfg.t_i[g]))
        params_G = _stack([x[0] for x in outs])
        opt_G = _stack([x[1] for x in outs])
        metrics = {k: torch.stack([torch.as_tensor(x[2][k], device=dev)
                                   for x in outs]) for k in outs[0][2]}
        metrics["inner_steps"] = metrics["inner_steps"].to(torch.int32)
        consensus_pre = _consensus_sq_tree(params_G)
        # every stream (params and moments) through the exchange; the step
        # count never is. The local steps' results are the round's own
        # (the exchange mixes them in place); a lossy stream's codec
        # encodes the delta against the caller's round-start leaves
        xs = {"params": params_G, **{k: opt_G[k] for k in mkeys}}
        xs0 = {k: (state_G["params"] if k == "params" else state_G["opt"][k])
               for k in xs if exch.lossy_stream(k)}
        mixed, comm_state = exch.streams(xs, xs0, comm_state)
        mixed = _clamp_nonneg_streams(mixed, opt, exch)
        n = sum(x.numel() // G for x in tree.leaves(params_G))
        msizes = {k: sum(x.numel() // G for x in tree.leaves(opt_G[k]))
                  for k in mkeys}
        metrics.update(_round_wire_bytes(exch, n, msizes))
        metrics.update(_obs_round_metrics(
            exch, comm_state, ("params",) + mkeys, consensus_pre,
            _consensus_sq_tree(mixed["params"]), G, dev, "torch"))
        out = {"params": mixed["params"],
               "opt": {k: mixed.get(k, v) for k, v in opt_G.items()}}
        if "comm" in state_G:
            out["comm"] = comm_state
        return out, metrics

    return round_


# ---------------------------------------------------------------------------
# The packed round
# ---------------------------------------------------------------------------


def _make_packed_local_round(loss_fn, opt, cfg, layout, exch):
    if cfg.metrics not in ("traj", "final"):
        raise ValueError(f"metrics={cfg.metrics!r} (have 'traj', 'final')")
    if cfg.threshold is not None:
        raise NotImplementedError(
            "threshold (T_i=inf) mode runs on the pytree path")
    if cfg.t_i is not None and cfg.inner_mode == "microbatch":
        raise NotImplementedError(
            "t_i is only defined for fixed_batch mode (the pytree path "
            "silently ignores it for microbatch)")
    packing.check_packed_index_space(layout, cfg.n_groups)
    per_group_count = cfg.t_i is not None and opt.count_dependent
    mkeys = (packing.stream_layout_for(opt, layout).moment_streams
             if cfg.average_opt_state else ())
    flat_vg = packing.value_and_flat_grad(loss_fn, layout)
    traj = cfg.metrics == "traj"
    micro = cfg.inner_mode == "microbatch"
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
        if exch.overlap:
            # delayed mixing (DESIGN.md §14): the previous round's payload
            # is mixed first, into fresh buffers (it depends on nothing the
            # local steps compute)
            inflight = comm_state["inflight"]
            mixed_inf = exch.mix_inflight(inflight)
        batches = [tree.tree_map(lambda x: x[g], batch_G) for g in range(G)]
        if micro:
            # (T, G): one microbatch a step
            steps = [[tree.tree_map(lambda x: x[t], b) for b in batches]
                     for t in range(T)]
        # (T, G) step mask of the t_i schedule, made once per round
        active = (None if cfg.t_i is None else
                  (torch.arange(T)[:, None]
                   < torch.tensor(cfg.t_i)[None, :]).to(dev))
        grads = torch.empty_like(params)
        losses, gsqs = [], []
        for t in range(T):
            bt = steps[t] if micro else batches
            loss_t = torch.stack([flat_vg(params[g], bt[g],
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
            # one extra loss/grad at the round's result (on the last
            # microbatch in microbatch mode); its norm is the per-leaf sum
            last = steps[-1] if micro else batches
            loss_G, gsq_G = [], []
            for g in range(G):
                loss, leaf_grads = packing.value_and_leaf_grads(
                    loss_fn, layout, params[g], last[g])
                loss_G.append(loss)
                gsq_G.append(grad_sq_norm(leaf_grads))
            metrics = {"loss": torch.stack(loss_G), "inner_steps": n_steps,
                       "grad_sq": torch.stack(gsq_G)}

        consensus_pre = _consensus_sq_flat(params, opt.impl)
        # every stream (params and moments) through the exchange; the
        # step count is never exchanged
        xs = {"params": params, **{k: opt_state[k] for k in mkeys}}
        if exch.overlap:
            # p' = local(p) + mix(inflight) - inflight, in place; p' (not
            # the local iterate) goes in flight, encoded against the round
            # start as the barrier round's codecs encode
            for k, x in xs.items():
                d = mixed_inf.pop(k).sub_(inflight[k])
                x.add_(d)
                del d
            mixed = _clamp_nonneg_streams(xs, opt, exch)
            new_inflight, comm_state = exch.encode_streams(mixed, xs0,
                                                           comm_state)
            comm_state = {**comm_state, "inflight": new_inflight}
        else:
            mixed, comm_state = exch.streams(xs, xs0, comm_state)
            mixed = _clamp_nonneg_streams(mixed, opt, exch)
        del xs0, xs
        params = mixed["params"]
        opt_state.update({k: mixed[k] for k in mkeys})
        metrics.update(_round_wire_bytes(exch, layout.padded,
                                         {k: layout.padded for k in mkeys}))
        metrics.update(_obs_round_metrics(
            exch, comm_state, ("params",) + tuple(mkeys), consensus_pre,
            _consensus_sq_flat(params, opt.impl), G, dev, opt.impl))
        out = {"params": params, "opt": opt_state}
        if "comm" in state_G:
            out["comm"] = comm_state
        return out, metrics

    return round_


# ---------------------------------------------------------------------------
# The packed round on sharded buffers (DESIGN.md §9)
# ---------------------------------------------------------------------------


def _make_sharded_round(loss_fn, opt, cfg, layout, exch, sexec):
    if cfg.metrics not in ("traj", "final"):
        raise ValueError(f"metrics={cfg.metrics!r} (have 'traj', 'final')")
    if cfg.threshold is not None:
        raise NotImplementedError(
            "threshold (T_i=inf) mode runs on the pytree path")
    if cfg.t_i is not None and cfg.inner_mode == "microbatch":
        raise NotImplementedError(
            "t_i is only defined for fixed_batch mode (the pytree path "
            "silently ignores it for microbatch)")
    # the reference checks the padded (G, Np) buffer before it shards
    packing.check_packed_index_space(layout, cfg.n_groups)
    if cfg.t_i is not None and opt.count_dependent:
        raise NotImplementedError(
            "per-node t_i with a count-dependent update keeps a (G,) "
            "count vector outside the sharded opt step; run it on the "
            "replicated packed path (DESIGN.md §10)")
    if sexec.n_groups != cfg.n_groups:
        raise ValueError(f"the mesh holds {sexec.n_groups} groups but "
                         f"cfg.n_groups={cfg.n_groups}")
    sexec.check_layout(layout)
    mkeys = (packing.stream_layout_for(opt, layout).moment_streams
             if cfg.average_opt_state else ())
    flat_vg = packing.value_and_flat_grad(loss_fn, layout)
    opt_step = sexec.opt_step(opt)
    if exch.overlap:
        mix_inflight = sexec.mix_streams(exch)
        encode_streams = sexec.encode_streams(exch, layout)
    else:
        exch_streams = sexec.exchange_streams(exch, layout)
    consensus = sexec.consensus_sq_groups(opt.impl)
    mesh, g = sexec.mesh, sexec.group_index
    lo, hi = sexec.bounds(layout)
    traj = cfg.metrics == "traj"
    micro = cfg.inner_mode == "microbatch"
    G, T = cfg.n_groups, cfg.inner_steps

    def round_(state, batch_G):
        _check_comm_state(exch, state, mkeys)
        comm_state = state.get("comm", {})
        params = state["params"]                       # (1, shard)
        dev = params.device
        opt_state = dict(state["opt"])
        xs0 = {k: (params if k == "params" else opt_state[k]).clone()
               for k in ("params",) + tuple(mkeys) if exch.lossy_stream(k)}
        if exch.overlap:
            # the previous round's payload is mixed first (DESIGN.md §14),
            # as the unsharded packed round does
            inflight = comm_state["inflight"]
            mixed_inf = mix_inflight(inflight)
        batch = tree.tree_map(lambda x: x[g], batch_G)
        steps = ([tree.tree_map(lambda x: x[t], batch) for t in range(T)]
                 if micro else None)
        full = torch.empty((layout.padded,), dtype=torch.float32,
                           device=dev)
        full_grad = torch.empty_like(full)
        grads = torch.empty_like(params)
        losses, parts = [], []
        for t in range(T):
            # the group's params over the shard subgroup; the gradient on
            # the group's whole batch, then this rank's shard of it
            mesh.all_gather(params[0], "shard", out=full)
            loss, _ = flat_vg(full, steps[t] if micro else batch,
                              out=full_grad)
            grads[0].copy_(full_grad[lo:hi])
            act = (None if cfg.t_i is None else torch.tensor(
                [t < cfg.t_i[g]], device=dev))
            params, opt_state = opt_step(params, grads, opt_state,
                                         active=act)
            if traj:
                losses.append(loss)
                parts.append(sq_norm_groups(grads, impl=opt.impl))
        del grads, full_grad
        n_steps = torch.tensor(cfg.t_i if cfg.t_i is not None else [T] * G,
                               dtype=torch.int32, device=dev)
        if traj:
            gsq_traj = sexec.shard_sums(torch.cat(parts))     # (G, T)
            loss_traj = sexec.groups_of(torch.stack(losses))
            metrics = {"loss": loss_traj[:, -1], "inner_steps": n_steps,
                       "grad_sq": gsq_traj[:, -1],
                       "grad_sq_first": gsq_traj[:, 0],
                       "grad_sq_traj": gsq_traj}
        else:
            mesh.all_gather(params[0], "shard", out=full)
            loss, leaf_grads = packing.value_and_leaf_grads(
                loss_fn, layout, full, steps[-1] if micro else batch)
            both = sexec.groups_of(torch.stack(
                [loss.to(torch.float32), grad_sq_norm(leaf_grads)]))
            del leaf_grads
            metrics = {"loss": both[:, 0], "inner_steps": n_steps,
                       "grad_sq": both[:, 1]}
        del full
        consensus_pre = consensus(params)
        xs = {"params": params, **{k: opt_state[k] for k in mkeys}}
        if exch.overlap:
            # p' = local(p) + mix(inflight) - inflight on each block, in
            # place; p' goes in flight, encoded against the round start
            for k, x in xs.items():
                x.add_(mixed_inf.pop(k).sub_(inflight[k]))
            mixed = _clamp_nonneg_streams(xs, opt, exch)
            new_inflight, comm_state = encode_streams(mixed, xs0, comm_state)
            comm_state = {**comm_state, "inflight": new_inflight}
        else:
            mixed, comm_state = exch_streams(xs, xs0, comm_state)
            mixed = _clamp_nonneg_streams(mixed, opt, exch)
        del xs0, xs
        params = mixed["params"]
        opt_state.update({k: mixed[k] for k in mkeys})
        metrics.update(_round_wire_bytes(exch, layout.padded,
                                         {k: layout.padded for k in mkeys}))
        metrics.update(_obs_round_metrics(
            exch, comm_state, ("params",) + tuple(mkeys), consensus_pre,
            consensus(params), G, dev, opt.impl,
            sq_groups=sexec.sq_norm_groups(opt.impl)))
        out = {"params": params, "opt": opt_state}
        if "comm" in state:
            out["comm"] = comm_state
        return out, metrics

    return round_


# ---------------------------------------------------------------------------
# Conventional baseline: synchronous data parallelism (one step per batch)
# ---------------------------------------------------------------------------


def make_sync_step(loss_fn: Callable, opt: Optimizer,
                   layout: Optional[packing.Layout] = None):
    """Standard DP: ``step(state, batch) -> (state, {"loss", "grad_sq"})``
    on the global batch; state has no G axis. With ``layout`` (and a
    packed optimizer) the state is the flat (N,) buffer, the update is
    one fused launch on its one-row view and ``grad_sq`` one ``sq_norm``
    launch, both in place of the buffer the state holds."""
    if layout is not None or opt.packed:
        if layout is None or not opt.packed:
            raise ValueError(
                "packed sync steps need BOTH a packing.Layout and a "
                "packed optimizer")
        packing.check_packed_index_space(layout)
        flat_vg = packing.value_and_flat_grad(loss_fn, layout)

        def packed_step(state, batch):
            loss, g = flat_vg(state["params"], batch)
            new_p, new_o = opt.step(state["params"], g, state["opt"])
            return ({"params": new_p, "opt": new_o},
                    {"loss": loss, "grad_sq": sq_norm(g, impl=opt.impl)})

        return packed_step

    vg = _value_and_grad(loss_fn)

    def step(state, batch):
        loss, g = vg(state["params"], batch)
        new_p, new_o = opt.step(state["params"], g, state["opt"])
        return ({"params": new_p, "opt": new_o},
                {"loss": loss, "grad_sq": grad_sq_norm(tree.leaves(g))})

    return step


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


def init_state(params, opt: Optimizer, n_groups: Optional[int] = None,
               layout: Optional[packing.Layout] = None,
               exchange: Optional[comm_mod.Exchange] = None,
               average_opt_state: bool = True, shardexec=None):
    """The train state of a round (``n_groups``) or of a sync step (no
    G axis). Packed (``layout``): the params tree packed to (N,), copied
    to every row of a (G, N) buffer, plus the optimizer's state; with
    ``shardexec``, this rank's (1, shard) block of it (the exchange's
    state then shards alike: the in-flight payload, the staleness
    buffers and push-sum's backlogs, of flat push_sum and of the tiers,
    take the block's shape, the mass counters stay the full (G,)
    host vectors). Pytree: the params tree and its optimizer
    state, replicated over G (the count too, so each group keeps its
    own). An exchange that carries state between rounds adds it under
    ``"comm"``, for the params and (when the rounds average opt state)
    every moment stream."""
    if shardexec is not None:
        if layout is None or not n_groups:
            raise ValueError("a sharded state is a packed round's: pass "
                             "layout= and n_groups")
        shardexec.check_layout(layout)
        lo, hi = shardexec.bounds(layout)
        buf = packing.pack(params, layout)[lo:hi][None].clone()
        state = {"params": buf, "opt": opt.init(buf)}
    elif layout is not None:
        buf = packing.pack(params, layout)
        if n_groups:
            buf = buf[None].repeat(n_groups, 1)
        state = {"params": buf, "opt": opt.init(buf)}
    else:
        state = {"params": params, "opt": opt.init(params)}
        if n_groups:
            state = replicate(state, n_groups)
    if exchange is not None and exchange.stateful:
        if not n_groups:
            raise ValueError("stateful exchanges need a grouped state "
                             "(pass n_groups)")
        moments = ({k: v for k, v in state["opt"].items() if k != "count"}
                   if average_opt_state else {})
        state["comm"] = exchange.init(state["params"],
                                      moments=moments or None)
    return state


def server_params(state_G, layout: Optional[packing.Layout] = None,
                  shardexec=None):
    """The averaged (server) model of a grouped state, as a tree; of a
    sharded state, on every rank (a collective: the G-mean of each block,
    gathered over the shard subgroup)."""
    if shardexec is not None:
        mean = shardexec.pmean(state_G["params"].clone())
        row = shardexec.mesh.all_gather(mean[0], "shard").reshape(-1)
        return packing.unpack(row, layout)
    if layout is not None:
        buf = state_G["params"]
        if buf.dim() > 1:
            buf = buf.mean(dim=0)
        return packing.unpack(buf, layout)
    return tree.tree_map(lambda x: x.mean(dim=0), state_G["params"])
