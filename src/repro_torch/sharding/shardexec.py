"""Sharded execution of the packed round over ``torch.distributed`` ranks
(counterpart of ``repro/sharding/shardexec.py``; DESIGN.md §9, §11).

The reference splits the (G, Np) packed buffers of a round over a mesh
of G groups by S in-group shards and runs ``shard_map`` blocks on each
device's (1, Np / S) block. The port runs one process per block: rank
``g * S + s`` of a ``launch.mesh.Mesh`` holds shard s of group g of every
stream (params, the optimizer's moments, the codec residuals and the
staleness and backlog buffers, which shard like the params), and the
block's work is eager torch on its device:

* the optimizer step: the packed ``opt.step`` on the local (1, shard)
  block, so ``fused_sgd``, ``fused_momentum`` and ``fused_adamw`` launch
  on the shard; the step count is the same scalar on every rank;
* ``||g||^2`` and the consensus distance: ``sq_norm_groups`` on the
  local block, an ``all_reduce`` SUM over the shard subgroup, the (G,)
  vector gathered over the group subgroup (the consensus mean is an
  ``all_reduce`` over the group subgroup, divided by G);
* the exchange, ``Exchange.streams``' semantics with collectives: the
  server and async mean an ``all_reduce`` over the group subgroup,
  ring and gossip one neighbour exchange per circulant offset of W
  (``hop_impl="ppermute"``: a ``batch_isend_irecv`` per hop, dest g
  receiving the block of ``(g + d) % G``) or the dense
  ``hop_impl="allgather"``; both assemble the same (G, shard) rows and
  contract them with this group's W row, so they are bit-equal. Codecs
  run on the local block: a cast is element-wise; int8's noise is drawn
  at the full rows shape from the codec's ``(seed, count)`` and each
  rank takes its slice, so the block's codec output is bit-equal to the
  unsharded one (``qdq_int8`` on the card); top-k selects by a
  per-group threshold found from shard-local top-k bounds and
  ``TOPK_BISECT_ITERS`` bisection steps (a MAX and an integer SUM
  ``all_reduce`` over the shard subgroup), at most k entries, never the
  zero pad, with the error-feedback residual kept shard-local. Fault
  masks are made on the host at their full (G,) and (G, G) shapes,
  identical on every rank; push_sum's value blocks travel point to point
  and its weight channel is the replicated exchange's host arithmetic,
  the same on every rank. ``codec_mix`` does not run here: it needs all
  G rows in one place;
* the two-tier exchange (``_hier_fn``, ``Exchange._hier_streams``'
  semantics): every mask, liveness vector, leader weight and the push-sum
  weight channel are ``Exchange.hier_round``'s host arrays at full (G,)
  shape, the ones the replicated round uses; within pods a ring runs one
  ``Mesh.permute`` per pod-circulant offset (or reads the dense
  allgather, bit-equal), a server sums the pod-mates' blocks in offset
  order; across pods push_sum ships stride-``pod_size`` shifts with the
  backlogs that conserve mass, a server sums the elected
  leaders' blocks (an int8 cross-tier codec on the shard, its noise
  drawn at the full rows shape and sliced);
* the overlapped exchange: ``mix_streams`` mixes the previous round's
  in-flight payload with ``mix`` a stream, ``encode_streams`` encodes
  each stream once on its block (int8's noise sliced from the full
  draw, top-k by the sharded threshold with its shard-local residual).

Refused, as in the reference: a ``downlink_codec``, a codec that is not
``shardable``, async_stale with top-k, push_sum with a lossy codec, and
on the two tiers a flat ``FaultPlan``, an intra codec other than a cast
and a push_sum inter tier with one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.comm import topology as topo_mod
from repro_torch.kernels.sq_norm import sq_norm_groups as _sq_norm_groups
from repro_torch.launch.mesh import GROUP_AXES, SHARD_AXES, Mesh
from repro_torch.optim import packing

# bisection steps refining the sharded top-k threshold: each halves the
# [lo, hi] bracket, so 26 resolve ~1e-8 of the value range; the mass left
# unselected near the threshold waits one round in the residual
TOPK_BISECT_ITERS = 26

def _check_shardable(codecs) -> None:
    for c in codecs:
        if not (c.shardable or c.identity):
            raise NotImplementedError(
                f"codec {c.name!r} is not shardable — run it on the "
                "replicated path (DESIGN.md §9)")


def check_exchange(exch) -> None:
    """Refuse what the sharded exchange does not run, as the reference
    does: a downlink codec, a codec that is not shardable, async_stale
    with top-k, push_sum with a codec other than a cast, and the two
    tiers' own refusals (``Exchange.check_hier``). Shapes only: the
    launcher checks before it starts any rank."""
    if exch.topology == "hierarchical":
        pairs = [(exch.stream_codec(k), exch.inter_stream_codec(k))
                 for k in ("params", "mu")]
        exch.check_hier(pairs)
        _check_shardable(ic for _, ic in pairs)
        return
    if exch.topology == "push_sum":
        for c in (exch.codec, exch.mcodec):
            if not (c.identity or c.name in ("fp16", "bf16")):
                raise NotImplementedError(
                    f"push_sum + {c.name}: the push-sum wire carries "
                    "cumulative mass, not round deltas (DESIGN.md §12); "
                    "valid push_sum codecs: 'fp32', 'fp16', 'bf16'")
        return
    _check_shardable((exch.codec, exch.mcodec))
    if exch.downlink_codec is not None:
        raise NotImplementedError(
            "downlink_codec is replicated-path only: its broadcast-"
            "reference state is not threaded through the sharded "
            "exchange (DESIGN.md §11)")
    if exch.topology == "async_stale" and exch.codec.topk_frac > 0:
        raise NotImplementedError(
            "async_stale + topk: the staleness schedule drops "
            "non-pushing rounds, error feedback assumes delivery "
            "(DESIGN.md §8)")


@dataclasses.dataclass(frozen=True, eq=False)
class ShardExec:
    """Static plan: which mesh axes carry groups and which in-group
    shards, and the ring/gossip hop collective."""
    mesh: Mesh
    group_axes: Tuple[str, ...]
    shard_axes: Tuple[str, ...]
    # "ppermute": one point-to-point exchange per circulant offset of W
    # (O(deg * shard) wire a hop); "allgather": the dense O(G * shard) hop
    hop_impl: str = "ppermute"

    def __post_init__(self):
        if self.hop_impl not in ("ppermute", "allgather"):
            raise ValueError(f"unknown hop_impl {self.hop_impl!r} "
                             "(have 'ppermute', 'allgather')")

    @property
    def n_shards(self) -> int:
        n = 1
        for a in self.shard_axes:
            n *= self.mesh.shape[a]
        return n

    @property
    def n_groups(self) -> int:
        n = 1
        for a in self.group_axes:
            n *= self.mesh.shape[a]
        return n

    @property
    def group_index(self) -> int:
        """This rank's linear group index (group axes major to minor)."""
        return self.mesh.group_index

    @property
    def shard_index(self) -> int:
        return self.mesh.shard_index

    def check_layout(self, layout: packing.Layout, chunk: int = 0) -> None:
        if not isinstance(layout, packing.ShardedLayout):
            raise ValueError(
                "sharded execution needs a packing.ShardedLayout "
                "(packing.shard_layout(layout, n_shards)) — got a plain "
                "Layout whose buffer does not split into shards")
        if layout.n_shards != self.n_shards:
            raise ValueError(
                f"layout sharded {layout.n_shards}-way but the mesh's "
                f"in-group axes {self.shard_axes} hold {self.n_shards} "
                "ranks")
        if chunk and layout.shard_size % chunk:
            raise ValueError(
                f"shard size {layout.shard_size} is not a multiple of the "
                f"codec chunk {chunk}; build the layout with "
                f"packing.shard_layout(..., align={chunk}) so per-chunk "
                "scales stay shard-local")

    # -- blocks ---------------------------------------------------------------

    def bounds(self, layout: packing.ShardedLayout) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of a row of the padded buffer."""
        lo = self.shard_index * layout.shard_size
        return lo, lo + layout.shard_size

    def local(self, x_G: torch.Tensor,
              layout: packing.ShardedLayout) -> torch.Tensor:
        """This rank's (1, shard) block of a (G, Np) buffer (a copy)."""
        lo, hi = self.bounds(layout)
        return x_G[self.group_index:self.group_index + 1, lo:hi].clone()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The (G, Np) buffer of every rank's (1, shard) block (a
        collective of the whole world)."""
        row = self.mesh.all_gather(x[0], "shard").reshape(1, -1)
        return self.mesh.all_gather(row[0], "group")

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """The G-mean of a block, in place: SUM over the group subgroup,
        divided by G."""
        return self.mesh.all_reduce(x, "group").div_(self.n_groups)

    def groups_of(self, v: torch.Tensor) -> torch.Tensor:
        """(G, ...) of every group's ``v`` (equal on a group's shards)."""
        return self.mesh.all_gather(v, "group")

    # -- fused optimizer update -------------------------------------------

    @staticmethod
    def opt_step(opt):
        """The step of the (1, shard) blocks: the packed ``opt.step`` as it
        is, element-wise, so the fused update kernel runs on the shard;
        the step count is the shared scalar on every rank."""
        return opt.step

    # -- metrics -----------------------------------------------------------

    def shard_sums(self, parts: torch.Tensor) -> torch.Tensor:
        """Shard-local partial sums (k,) -> (G, k): SUM over the shard
        subgroup, then every group's row."""
        return self.groups_of(self.mesh.all_reduce(parts, "shard"))

    def sq_norm_groups(self, impl: str = "auto"):
        """Per-group ||x||^2 of a sharded buffer -> (G,): the
        ``sq_norm_groups`` kernel on the local block, a SUM over the
        shard subgroup."""
        def fn(x):
            return self.shard_sums(_sq_norm_groups(x, impl=impl))[:, 0]

        return fn

    def consensus_sq_groups(self, impl: str = "auto"):
        """Per-group consensus distance ||x_g - mean||^2 -> (G,): the
        fleet mean over the group subgroup, the deviation reduced on the
        local block and summed over the shard subgroup."""
        def fn(x):
            x32 = x.to(torch.float32)
            d = x32 - self.pmean(x32.clone())
            return self.shard_sums(_sq_norm_groups(d, impl=impl))[:, 0]

        return fn

    # -- codec-free mixing ------------------------------------------------

    def mix(self, exch):
        """``Exchange.mix`` on one sharded buffer: the G-mean for server
        and async, ``mix_rounds`` W hops for ring and gossip. The fp32
        streams of ``exchange_streams`` take these same ops."""
        if exch.topology == "none":
            return lambda x: x
        hop = self._hop_fn(exch.w)

        def fn(x):
            if hop is None:
                return self.pmean(x.clone())
            y = x
            for _ in range(exch.mix_rounds):
                y = hop(y)
            return y

        return fn

    def mix_streams(self, exch):
        """``Exchange.mix_inflight`` on sharded buffers (the overlapped
        round, DESIGN.md §14): the codec-free mix of the previous round's
        in-flight payload, one ``mix`` a stream, into fresh blocks (the
        round still reads ``inflight``)."""
        one = self.mix(exch)
        return lambda inflight: {k: one(v) for k, v in inflight.items()}

    def encode_streams(self, exch, layout: packing.Layout):
        """``Exchange.encode_streams`` on sharded buffers: every stream
        encoded once on its (1, shard) block, no mixing: an identity codec
        ships a copy, a lossy one ``x0 + decode(encode(x - x0))``; int8's
        noise is drawn at the full rows shape and sliced (the block's
        output bit-equal to the unsharded encode), top-k selects by the
        sharded threshold with its shard-local residual (kept although
        ``get_exchange`` refuses overlap with top-k). Returns ``fn(xs,
        xs0, comm_state) -> (x_hat, new_comm_state)``."""
        _check_shardable((exch.codec, exch.mcodec))
        for c in (exch.codec, exch.mcodec):
            if (not c.identity) and c.chunk > 0:
                self.check_layout(layout, c.chunk)
        self.check_layout(layout)

        def fn(xs, xs0, comm_state):
            new_state = dict(comm_state)
            cstates = dict(comm_state.get("codec", {}))
            touched = False
            out = {}
            for k, x in xs.items():
                codec = exch.stream_codec(k)
                if codec.identity:
                    out[k] = x.clone()
                    continue
                if codec.topk_frac > 0:
                    out[k], res = self._topk_step(
                        x, xs0[k], cstates[k]["residual"],
                        self._topk_k(codec, layout), layout.shard_size)
                    cstates[k] = {"residual": res}
                elif codec.chunk > 0:
                    cnt = cstates[k]["count"]
                    out[k] = self._compress_local(
                        codec, x, xs0[k],
                        self._noise(codec, cnt, layout, x.device))
                    cstates[k] = {"count": cnt + 1}
                else:
                    out[k] = self._compress_local(codec, x, xs0[k], None)
                touched = touched or codec.stateful
            if touched:
                new_state["codec"] = cstates
            return out, new_state

        return fn

    def _hop_fn(self, w_np):
        """One W hop of a local (1, shard) block, or None for the mean
        topologies. The received blocks fill a (G, shard) array (absent
        neighbours stay zero) that is contracted with this group's W row;
        0-weight terms make the ppermute hop bit-equal to the allgather
        hop. With ``mrow`` (this group's row of the hop's delivery mask)
        and ``act`` (its liveness) the hop is masked as the replicated
        ``_masked_hop``: the lost weight substitutes the receiver's own
        value, and a stalled receiver keeps its block."""
        if w_np is None:
            return None
        G, g = self.n_groups, self.group_index
        w_row = np.asarray(w_np, np.float32)[g]
        mesh = self.mesh
        offs = topo_mod.neighbor_offsets(w_np)

        def contract(y, full, mrow, act):
            row = torch.as_tensor(w_row, device=y.device)
            if mrow is None:
                return torch.tensordot(row, full, dims=([0], [0]))[None]
            rm = row * torch.as_tensor(mrow, device=y.device)
            out = torch.tensordot(rm, full, dims=([0], [0]))[None]
            out = out + (1.0 - rm.sum()) * y
            return out if act > 0 else y

        def hop(y, mrow=None, act=1.0):
            if self.hop_impl == "allgather":
                full = mesh.all_gather(y[0], "group")
            else:
                full = y.new_zeros((G,) + tuple(y.shape[1:]))
                full[g] = y[0]
                for d, recv in zip(offs, mesh.shift(y[0], offs)):
                    full[(g + d) % G] = recv
            return contract(y, full, mrow, act)

        return hop

    # -- codecs on a block --------------------------------------------------

    @staticmethod
    def _compress_local(codec, y, ref, u):
        """``ref + decode(encode(y - ref))`` on a local block; a chunked
        codec quantizes its rows with the noise ``u``."""
        d = y - ref
        if codec.chunk > 0:
            rows = d.reshape(-1, codec.chunk)
            return ref + codec.compress_rows(rows, u).reshape(d.shape)
        return ref + codec.compress(d, {})[0]

    def _noise(self, codec, count, layout: packing.ShardedLayout, device):
        """This rank's rows of the noise drawn at the full rows shape of
        the (G, Np) buffer."""
        G, c = self.n_groups, codec.chunk
        u = codec.noise(count, (G * layout.padded // c, c),
                        device).reshape(G, -1, c)
        rs = layout.shard_size // c
        lo = self.shard_index * rs
        return u[self.group_index, lo:lo + rs].clone()

    # -- sharded top-k selection (DESIGN.md §11) --------------------------

    @staticmethod
    def _topk_k(codec, layout: packing.Layout) -> int:
        """Entries a group ships: the fraction of the padded row."""
        return max(1, int(round(codec.topk_frac * layout.padded)))

    def _topk_step(self, y, ref, res, k: int, shard_size: int):
        """One top-k encode of a block: ``(ref + d_hat, residual)``."""
        c = (y - ref) + res
        tau = self._topk_threshold(c.abs()[0], k, shard_size)
        d_hat, res = self._topk_select(c, tau)
        return ref + d_hat, res

    def _topk_threshold(self, a, k: int, shard_size: int):
        """The per-group threshold of the sharded top-k codec: the largest
        local k-th value bounds the global k-th from below (that shard
        alone proves count(>= lo) >= k), the global max from above, and
        ``TOPK_BISECT_ITERS`` counted bisection steps shrink the bracket.
        Returns ``hi``, the conservative end: at most k entries pass.
        ``a``: the shard-local |c| (shard,)."""
        mesh = self.mesh
        top = torch.topk(a, min(k, shard_size), sorted=True).values
        hi = mesh.all_reduce(top[:1].clone(), "shard", "max")
        lo = (mesh.all_reduce(top[-1:].clone(), "shard", "max")
              if k <= shard_size else torch.zeros_like(hi))
        for _ in range(TOPK_BISECT_ITERS):
            mid = 0.5 * (lo + hi)
            cnt = mesh.all_reduce((a >= mid).sum().view(1), "shard")
            big = cnt > k
            lo, hi = torch.where(big, mid, lo), torch.where(big, hi, mid)
        return hi

    @staticmethod
    def _topk_select(c, tau):
        """Ship ``|c| >= tau`` (never a zero: the pad and dead coordinates
        stay off the wire), carry the rest: ``c == d_hat + residual``
        exactly."""
        keep = (c.abs() >= tau) & (c.abs() > 0.0)
        d_hat = torch.where(keep, c, torch.zeros_like(c))
        return d_hat, c - d_hat

    # -- the communication step -------------------------------------------

    def exchange_streams(self, exch, layout: packing.Layout):
        """``Exchange.streams`` on sharded buffers: ``fn(xs, xs0,
        comm_state) -> (mixed, new_comm_state)`` over ``{stream: (1,
        shard) block}`` dicts, with per-stream codec state, async_stale's
        and the faulty server's staleness buffers, per-hop recompression
        on ring and gossip, and fault plans."""
        check_exchange(exch)
        if exch.topology == "push_sum":
            return self._push_sum_fn(exch, layout)
        if exch.topology == "hierarchical":
            return self._hier_fn(exch, layout)
        for c in (exch.codec, exch.mcodec):
            if (not c.identity) and c.chunk > 0:
                self.check_layout(layout, c.chunk)
        self.check_layout(layout)
        G, g = self.n_groups, self.group_index
        hops = exch.mix_rounds if exch.w is not None else 1
        hop = self._hop_fn(exch.w)
        plan = exch.fault_plan
        faulty = plan is not None and exch.topology != "none"
        # a faulty server keeps async_stale's staleness buffers: a dropped
        # push contributes its last delivered model
        buffered = (exch.topology == "async_stale"
                    or (faulty and exch.topology == "server"))
        rs = layout.shard_size

        def fn(xs, xs0, comm_state):
            new_state = dict(comm_state)
            cstates = dict(comm_state.get("codec", {}))
            touched = False
            rnd = int(comm_state["round"]) if "round" in comm_state else 0
            # the fault masks, at full shape on the host: the arrays the
            # replicated exchange uses
            if faulty and exch.w is not None:
                mrows = [plan.matrix_mask(rnd, h, G)[g] for h in range(hops)]
                act = float(plan.active_mask(rnd, G)[g])
            elif faulty:
                deliver = plan.push_mask(rnd, G)
            if exch.topology == "async_stale":
                keep0 = (g + rnd) % (exch.staleness + 1) == 0
            else:
                keep0 = True
            mixed, pushed = {}, {}
            for k, x in xs.items():
                codec = exch.stream_codec(k)
                lossy = (not codec.identity) and exch.topology != "none"
                selective = lossy and codec.topk_frac > 0
                chunked = lossy and codec.chunk > 0
                n_comp = (hops if exch.w is not None else 1) if lossy else 0
                res = cstates[k]["residual"] if selective else None
                if chunked:
                    cnt = int(cstates[k]["count"])
                    us = [self._noise(codec, cnt + h, layout, x.device)
                          for h in range(n_comp)]
                    cstates[k] = {"count": cstates[k]["count"] + n_comp}
                    touched = True
                k_sel = self._topk_k(codec, layout) if selective else 0

                if exch.w is not None:                 # ring / gossip
                    y, ref = x, xs0.get(k)
                    for h in range(hops):
                        if selective:
                            y, res = self._topk_step(y, ref, res, k_sel,
                                                     rs)
                            ref = y
                        elif lossy:
                            y = self._compress_local(codec, y, ref, us[h]
                                               if chunked else None)
                            ref = y
                        y = (hop(y, mrows[h], act) if faulty else hop(y))
                    mixed[k] = y
                else:
                    if selective:
                        y, res = self._topk_step(x, xs0[k], res, k_sel,
                                                 rs)
                    elif lossy:
                        y = self._compress_local(codec, x, xs0[k],
                                           us[0] if chunked else None)
                    else:
                        y = x
                    keep = keep0
                    if faulty and buffered:
                        arrived = bool(deliver[g] > 0)
                        if selective and keep and not arrived:
                            # a scheduled push that dropped re-offers its
                            # shipped entries next round
                            res = res + (y - xs0[k])
                        keep = keep and arrived
                    if buffered:
                        old = (comm_state["pushed"] if k == "params"
                               else comm_state["pushed_opt"][k])
                        pushed[k] = y.clone() if keep else old
                        mixed[k] = self.pmean(pushed[k].clone())
                    elif exch.topology == "none":
                        mixed[k] = y
                    else:                # server: in place, as the
                        mixed[k] = self.pmean(y)   # replicated mean
                if selective:
                    cstates[k] = {"residual": res}
                    touched = True
            if touched:
                new_state["codec"] = cstates
            if buffered:
                new_state["pushed"] = pushed["params"]
                mnames = [k for k in xs if k != "params"]
                if mnames:
                    po = dict(comm_state["pushed_opt"])
                    po.update({k: pushed[k] for k in mnames})
                    new_state["pushed_opt"] = po
            if buffered or (faulty and exch.w is not None):
                new_state["round"] = comm_state["round"] + 1
            if faulty:
                if exch.w is not None:
                    new_state["participation"] = \
                        exch._edge_participation(rnd)
                else:
                    sched = np.ones((G,), bool)
                    if exch.topology == "async_stale":
                        sched = (np.arange(G) + rnd) \
                            % (exch.staleness + 1) == 0
                    n_sched = np.float32(max(sched.astype(np.float32).sum(),
                                             1.0))
                    new_state["participation"] = torch.tensor(np.float32(
                        np.where(sched, deliver, np.float32(0)).sum(
                            dtype=np.float32) / n_sched))
            return mixed, new_state

        return fn

    def _push_sum_fn(self, exch, layout: packing.Layout):
        """Push-sum ratio consensus on sharded blocks, the replicated
        ``Exchange._push_sum_streams`` op for op: each group's block ships
        its share per offset point to point (the ring hops' transport),
        the per-edge backlogs shard like the params, and the masks and
        the weight channel are ``Exchange.push_sum_round``'s host arrays,
        the same on every rank."""
        self.check_layout(layout)
        G = self.n_groups
        offs = topo_mod.push_sum_offsets(G)
        # sender (g - d) % G pushes to g: the shift of offset -d
        back = [(-d) % G for d in offs]

        def fn(xs, xs0, comm_state):
            del xs0
            new_state = dict(comm_state)
            new_state["round"] = comm_state["round"] + 1
            if not offs:                           # G == 1: no wire
                return dict(xs), new_state
            ps = exch.push_sum_round(comm_state)
            dev = xs["params"].device

            def col(v):
                return self._own(v, dev)

            act = col(ps.act)
            masks = [[col(m) for m in mh] for mh in ps.masks]
            incs = [[col(m) for m in ih] for ih in ps.incs]
            backlog = dict(comm_state["backlog"])
            mixed = {}
            for k, v in xs.items():
                codec = exch.stream_codec(k)
                num = v.to(torch.float32) * col(ps.w0)
                for h in range(exch.mix_rounds):
                    num = self._push_sum_hop(num, backlog[k], ps.a, act, back,
                                             incs[h], masks[h], codec)
                mixed[k] = torch.div(num, col(ps.w), out=v)
            new_state.update(ps.state)
            new_state["backlog"] = backlog
            return mixed, new_state

        return fn

    def _own(self, v, device) -> torch.Tensor:
        """This group's entry of a (G,) host vector, a (1, 1) float32
        tensor on ``device``."""
        return torch.as_tensor(np.asarray(v, np.float32)[
            self.group_index:self.group_index + 1].reshape(1, 1),
            device=device)

    def _push_sum_hop(self, num, bl, a, act, back, incs, masks, codec):
        """One push-sum hop of a (1, shard) block, the replicated
        ``_push_sum_hop`` op for op: keep ``a * num`` where live, receive
        each offset's share point to point (the shift of ``back[di]``)
        into its backlog ``bl[di]`` (updated in place), add what the edge
        delivers (a cast codec quantizes it; its residue stays queued).
        ``act``, ``incs[di]`` and ``masks[di]`` are this group's (1, 1)
        entries."""
        ax = a * num
        y = torch.where(act > 0, ax, num)
        for di, r in enumerate(self.mesh.shift(ax, back)):
            r.mul_(incs[di])
            bl[di].add_(r)
            t = bl[di] if codec.identity else codec.compress(bl[di], {})[0]
            mt = masks[di] * t
            y.add_(mt)
            bl[di].sub_(mt)
        return y

    def _hier_fn(self, exch, layout: packing.Layout):
        """The two-tier round on sharded blocks (DESIGN.md §16), the
        replicated ``Exchange._hier_streams`` on ``Exchange.hier_round``'s
        host arrays (each rank reads its group's entries).

        Stage A, within pods (contiguous on the G axis): a ring runs
        ``mix_rounds`` pod-circulant hops, each offset's neighbour block
        through ``Mesh.permute`` (``hop_impl="allgather"``: read from one
        dense gather a hop, bit-equal), a cast codec on the payload and a
        lost payload replaced by the receiver's own value, as the
        replicated ring's ops in its order (bit-equal to it); a server
        sums the delivered pod-mates' blocks in offset order from self
        (the reference's order) over the survivors. Stage B, across pods:
        push_sum ships ``a * w * x`` along the stride-``pod_size`` shifts
        into backlogs that shard like the params (the mass and its
        backlog are the host arrays, the same on every rank); a server
        sums ``lead_w * y`` over the group subgroup (``all_reduce``) and
        divides by the live pods, the leader's payload coded as a delta
        against the round start by the cross-tier codec (int8 on the
        shard, its noise drawn at the full rows shape and sliced)."""
        for ic in map(exch.inter_stream_codec, ("params", "mu")):
            if (not ic.identity) and ic.chunk > 0:
                self.check_layout(layout, ic.chunk)
        self.check_layout(layout)
        G, g = self.n_groups, self.group_index
        s, mesh = exch.pod_len, self.mesh
        pod0, i = (g // s) * s, g % s

        def pod_blocks(v, offs):
            """The blocks of pod-mates ``(i + d) % s``, one per offset."""
            if self.hop_impl == "allgather":
                full = mesh.all_gather(v[0], "group")
                return [full[pod0 + (i + d) % s][None] for d in offs]
            return [b[None] for b in mesh.permute(
                v[0], [[(j // s) * s + (j % s + d) % s for j in range(G)]
                       for d in offs])]

        def cast(codec, t):
            return t if codec.identity else codec.compress(t, {})[0]

        def fn(xs, xs0, comm_state):
            hr = exch.hier_round(comm_state)
            new_state = dict(comm_state)
            dev = xs["params"].device
            act_i = hr.act_i[g] > 0
            ys = {k: x.to(torch.float32) for k, x in xs.items()}
            # ---- stage A: pod-internal tier ------------------------------
            if hr.masks_a:
                w_self, offs_pod, w_edge = topo_mod.ring_circulant(s)
                for k in ys:
                    codec, v = exch.stream_codec(k), ys[k]
                    for mh in hr.masks_a:
                        out = w_self * v
                        for di, t in enumerate(pod_blocks(v, offs_pod)):
                            t = cast(codec, t) if mh[di][g] > 0 else v
                            out.add_(t * w_edge)
                            del t
                        v = out if act_i else v
                    ys[k] = v
            elif hr.deliv is not None:                 # intra "server"
                den = hr.den[g // s]
                for k in ys:
                    codec, v = exch.stream_codec(k), ys[k]
                    num = float(hr.deliv[g]) * cast(codec, v)
                    for d, t in zip(range(1, s),
                                    pod_blocks(v, range(1, s))):
                        num = num + float(hr.deliv[pod0 + (i + d) % s]) \
                            * cast(codec, t)
                    if act_i and den > 0:
                        ys[k] = num / max(float(den), 1.0)
            # ---- stage B: cross-pod tier ---------------------------------
            cstates = dict(comm_state.get("codec", {}))
            touched = False
            mixed = {}
            if hr.act_pod is not None:                 # inter push_sum
                def col(v):
                    return self._own(v, dev)

                back = [(-sh) % G for sh in hr.shifts]
                act_pod = col(hr.act_pod)
                masks = [col(m) for m in hr.masks]
                incs = [col(m) for m in hr.incs]
                backlog = dict(comm_state["backlog"])
                for k, x in xs.items():
                    num = self._push_sum_hop(
                        ys.pop(k) * col(hr.w0), backlog[k], hr.a, act_pod,
                        back, incs, masks, exch.inter_stream_codec(k))
                    mixed[k] = torch.div(num, col(hr.w), out=x)
                new_state["backlog"] = backlog
            elif exch.inter_topology == "push_sum":    # single pod: no DCN
                mixed = {k: x.copy_(ys.pop(k)) for k, x in xs.items()}
            else:                                      # inter "server"
                lead_w = float(hr.lead_w[g])
                for k, x in xs.items():
                    ic = exch.inter_stream_codec(k)
                    y = ys.pop(k)
                    if not ic.identity:
                        key = "inter:" + k
                        u = None
                        if ic.chunk > 0:
                            cnt = cstates[key]["count"]
                            u = self._noise(ic, cnt, layout, dev)
                            cstates[key] = {"count": cnt + 1}
                            touched = True
                        y = self._compress_local(
                            ic, y, xs0[k].to(torch.float32), u)
                    m = mesh.all_reduce(lead_w * y, "group").div_(
                        float(hr.n_live))
                    mixed[k] = x.copy_(m if act_i else y)
                    del y, m
            if touched:
                new_state["codec"] = cstates
            new_state.update(hr.state)
            return mixed, new_state

        return fn

    def exchange(self, exch, layout: packing.Layout):
        """``exchange_streams`` for the params alone: ``(x, x0,
        comm_state) -> (mixed_x, new_comm_state)``."""
        fn = self.exchange_streams(exch, layout)

        def one(x, x0, comm_state):
            xs0 = {} if x0 is None else {"params": x0}
            mixed, new_state = fn({"params": x}, xs0, comm_state)
            return mixed["params"], new_state

        return one


def plan_for(mesh: Mesh, require: bool = False,
             hop_impl: str = "ppermute") -> Optional[ShardExec]:
    """The mesh's sharded-execution plan, or None when no in-group axis
    is larger than 1 (the unsharded round is then both right and free)."""
    shard_axes = tuple(a for a in SHARD_AXES
                       if a in mesh.axis_names and mesh.shape[a] > 1)
    if not shard_axes:
        if require:
            raise ValueError(
                f"mesh {dict(mesh.shape)} has no in-group axis "
                f"({'/'.join(SHARD_AXES)}) larger than 1 to shard the "
                "packed buffer over")
        return None
    group_axes = tuple(a for a in GROUP_AXES if a in mesh.axis_names)
    return ShardExec(mesh=mesh, group_axes=group_axes,
                     shard_axes=shard_axes, hop_impl=hop_impl)
