"""The round's model exchange (counterpart of ``repro/comm/exchange.py``;
DESIGN.md §8, §10-§12, §14, §16): a topology over the G axis, a codec per
stream, an optional fault plan, and the exact wire accounting.

  server       mean over G, broadcast back (with fp32: the same ops as
               ``average_groups``).
  ring/gossip  neighbour averaging ``x <- W^k x`` with the
               doubly-stochastic W of ``topology.py``, k = ``mix_rounds``.
  async_stale  server averaging with bounded staleness s: in round n only
               the groups with ``(g + n) % (s + 1) == 0`` push; the server
               averages every group's last push.
  push_sum     ratio consensus on the directed ring (DESIGN.md §12): each
               node pushes equal shares of a (value, weight) mass pair and
               estimates the model as their ratio; per-edge backlogs keep
               an undelivered share queued for the next delivery, so mass
               is conserved (to float32 precision) under any loss.
  none         no communication (W = I, zero wire bytes).
  hierarchical two tiers (DESIGN.md §16): G factors into ``n_pods``
               contiguous pods; each round mixes within pods
               (``intra_topology``: a pod-local ring or the pod mean), then
               across them (``inter_topology``: push_sum over pods, or the
               mean of the pods' elected leaders), with its own cross-tier
               codec (``inter_codec``) and a ``TieredFaultPlan``.

The payload is multi-stream: the params plus one stream per optimizer
moment. ``codec`` applies to the params, ``moment_codec`` to every
moment; each stream keeps its own codec state under
``comm_state["codec"][stream]`` and, for async_stale and the faulty
server, its own staleness buffer (``"pushed"``, ``"pushed_opt"][stream]``).
A ``downlink_codec`` re-encodes the server's (or async's) broadcast as a
delta against the last decoded broadcast (``comm_state["down"]``).

Faults (``comm/faults.py``): a ``FaultPlan`` masks the round's
transmissions from ``(round, seed)`` alone; the round counter rides the
comm state. server and async_stale fall back to a group's last delivered
push, an error-feedback residual takes back an undelivered payload
(``codecs.defer_undelivered``), ring and gossip substitute a receiver's
own value for a lost payload (rows stay stochastic, the mean drifts: the
bias push_sum exists to remove), and the round reports the delivered
fraction as ``participation``. No plan (the default) leaves every path
as it was. The masks, the round counter, the participation scalars and
push-sum's weight channel (``mass``, ``backlog_w``) are small and live on
the host; the value backlogs live beside the params.

Overlap (DESIGN.md §14): ``overlap=True`` mixes the PREVIOUS round's
encoded payload (``comm_state["inflight"]``, ``mix_inflight``) and
encodes this round's result for the next (``encode_streams``).

Routing, as in the reference (``_fusable``): int8, fp16 and bf16 on
server, ring and gossip, and top-k on server, run the fused ``codec_mix``
kernel (``kernels/exchange_epilogue.py``) on a (G, N) buffer over a
reliable network; under a fault plan, and on async_stale, push_sum, the
tiers and the overlap encode, every stream takes the staged codecs
(int8's core is the ``qdq_int8`` kernel).

The exchange works in place where it can: an fp32 stream and a fused
stream are mixed into the live (G, N) buffer, whose memory the round
owns, and push-sum's value backlogs are updated in place. What must
outlive the round (a staleness buffer, an in-flight payload, a backlog)
is never a view of a live buffer.

A stream's value is a (G, N) buffer (the packed round) or a tree of
(G, ...) tensors (the pytree round). A tree runs the staged path leaf by
leaf, each leaf as its (G, -1) view (``_each_leaf``), as the
reference's ``jax.tree.map`` runs it; it never reaches a kernel (the
reference's ``_fusable`` takes only a 2-D buffer). The host-side masks,
weights and counters are made once a round (once a hop for the hop
masks) and shared by every stream and leaf. A tree stream's push-sum
backlog is updated in a copy: the pytree round leaves its caller's
state as it was. ``check_tree`` refuses what the reference refuses
there: overlap, and the flat-only codecs (int8, int8z, top-k), whose
wire format is the packed buffer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.comm import codecs as codecs_mod
from repro_torch.comm import faults as faults_mod
from repro_torch.comm import topology as topo_mod
from repro_torch.kernels.exchange_epilogue import codec_mix

TOPOLOGIES = ("server", "ring", "gossip", "async_stale", "push_sum",
              "none", "hierarchical")

INTRA_TOPOLOGIES = ("ring", "server")        # pod-internal tier
INTER_TOPOLOGIES = ("push_sum", "server")    # cross-pod tier

# codecs whose wire format is the packed (G, N) buffer (the reference's
# flat_only codecs)
_FLAT_ONLY = ("int8", "int8z", "topk")

# moment streams default to the uncompressed wire
_FP32 = codecs_mod.fp32()


def _tensordot_w(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One codec-free W hop: a small (G, G) x (G, N) product, outside any
    kernel as in the reference. It must run in full float32 on the card:
    ``import repro_torch`` switches TF32 off, and a caller that switched
    it back on is refused here."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the exchange's W product runs in float32 like the reference: "
            "set torch.backends.cuda.matmul.allow_tf32 = False")
    return torch.tensordot(w, x, dims=([1], [0]))


def _f32(x) -> torch.Tensor:
    """A host float32 scalar (participation, a mean of masks)."""
    return torch.tensor(np.float32(x))


def _mask_mean(m: np.ndarray) -> np.float32:
    """The float32 mean of a 0/1 mask: its (exact) sum over its size."""
    return np.float32(m.sum(dtype=np.float32)) / np.float32(m.size)


def _each_leaf(fn, x, *rest):
    """``fn`` over one stream's value: a (G, N) buffer as it is, or each
    leaf of a tree of (G, ...) tensors as its (G, -1) view, beside the
    matching leaf of every tree in ``rest`` viewed alike (its own leading
    axes kept: a backlog's offset axis). Each result takes its leaf's
    shape; a write into a view lands in its leaf."""
    if isinstance(x, torch.Tensor) and x.dim() == 2:
        return fn(x, *rest)

    def leaf(a, *bs):
        def view(b):
            return b.view(tuple(b.shape[:b.dim() - a.dim()])
                          + (a.shape[0], -1))

        return fn(view(a), *map(view, bs)).view(a.shape)

    return tree.tree_map(leaf, x, *rest)


def _device(x):
    """The device of a stream's value (a buffer or a tree)."""
    return tree.leaves(x)[0].device


def _own_backlog(bl):
    """The push-sum backlog a round updates in place: the packed round's
    own buffer, or a copy of a tree stream's (the pytree round leaves its
    caller's state as it was, as the reference's functional round
    does)."""
    return bl if isinstance(bl, torch.Tensor) else tree.tree_map(
        torch.clone, bl)


def _col(m: np.ndarray, device) -> torch.Tensor:
    """A (G,) host mask as a (G, 1) float32 column on ``device``."""
    return torch.as_tensor(np.asarray(m, np.float32).reshape(-1, 1),
                           device=device)


def elect_leaders(act, n_pods: int):
    """Pod leaders from a (G,) liveness mask (DESIGN.md §16): the leader
    of each contiguous pod is its first live member, pure in the mask.
    Returns ``(leader_w, pod_live)`` as float32 numpy arrays: ``leader_w``
    (G,) one-hot per pod (all zero for a dead pod), ``pod_live``
    (n_pods,) (a pod is live while any member is)."""
    a = np.asarray(act, np.float32).reshape(n_pods, -1)
    pod_live = a.max(axis=1)
    onehot = np.zeros_like(a)
    onehot[np.arange(n_pods), a.argmax(axis=1)] = 1.0
    return (onehot * pod_live[:, None]).reshape(-1), pod_live


def _push_sum_weights(w, blw, a, act, shifts, incs, masks):
    """One push-sum hop of the weight channel, on the host in float32 (the
    reference's ops in its order): ``(mass', backlog_w')``."""
    a = np.float32(a)
    new_w = np.where(act > 0, a * w, w)
    new_blw = []
    for di, sh in enumerate(shifts):
        b = blw[di] + incs[di] * np.roll(a * w, sh)
        new_w = new_w + masks[di] * b
        new_blw.append(b - masks[di] * b)
    return new_w, np.stack(new_blw)


def _push_sum_hop(x, bl, a, act, shifts, incs, masks, codec):
    """One push-sum hop of one (G, N) value stream: each live node keeps
    ``a * x`` and adds every delivered edge's whole queue; ``bl`` (the
    per-offset backlogs) is updated in place. ``act``, ``incs[di]`` and
    ``masks[di]`` are (G, 1) columns. A cast codec quantizes what is
    transmitted and its residue stays queued."""
    ax = a * x
    y = torch.where(act > 0, ax, x)
    for di, sh in enumerate(shifts):
        r = torch.roll(ax, sh, 0)
        r.mul_(incs[di])
        bl[di].add_(r)
        del r
        t = bl[di] if codec.identity else codec.compress(bl[di], {})[0]
        mt = masks[di] * t
        del t
        y.add_(mt)
        bl[di].sub_(mt)
    return y


@dataclasses.dataclass(frozen=True)
class PushSumRound:
    """``Exchange.push_sum_round``: offsets, share ``a``, liveness ``act``
    (G,), ``masks[h][di]`` and ``incs[h][di]`` (G,), the mass before
    (``w0``) and after (``w``), and the comm-state entries it sets."""
    offs: tuple
    a: float
    act: np.ndarray
    masks: list
    incs: list
    w0: np.ndarray
    w: np.ndarray
    state: dict


@dataclasses.dataclass(frozen=True)
class HierRound:
    """``Exchange.hier_round``: the pod size ``s``; stage A's liveness
    ``act_i`` (G,) and its ring delivery masks ``masks_a[h][di]`` (G,)
    (empty unless the intra tier is a ring of s > 1) or its server's
    per-member delivery ``deliv`` (G,) and per-pod count ``den``
    (n_pods,); stage B's push-sum liveness ``act_pod`` (G,) (None unless
    a push_sum inter tier has a wire), share ``a``, G-axis ``shifts``,
    ``masks[di]``/``incs[di]`` (G,) and mass before (``w0``) and after
    (``w``), or its server's leader weights ``lead_w`` (G,) over
    ``n_live`` live pods; and the comm-state entries the round sets."""
    s: int
    act_i: np.ndarray
    masks_a: list
    deliv: Optional[np.ndarray]
    den: Optional[np.ndarray]
    act_pod: Optional[np.ndarray]
    a: float
    shifts: list
    masks: list
    incs: list
    w0: Optional[np.ndarray]
    w: Optional[np.ndarray]
    lead_w: Optional[np.ndarray]
    n_live: np.float32
    state: dict


@dataclasses.dataclass(frozen=True)
class Exchange:
    topology: str
    codec: codecs_mod.Codec             # the params stream's codec
    n_groups: int
    mix_rounds: int = 1
    staleness: int = 0
    # (G, G) doubly-stochastic mixing matrix; None = exact mean (server,
    # async, push_sum's codec-free mix) or identity (none)
    w: Optional[np.ndarray] = None
    # codec of every moment stream (None -> fp32)
    moment_codec: Optional[codecs_mod.Codec] = None
    # codec of the server/async broadcast reply (None: the idealized
    # broadcast, priced at the uplink widths)
    downlink_codec: Optional[codecs_mod.Codec] = None
    # route int8/fp16/bf16 (and server top-k) streams through the fused
    # codec_mix epilogue; False = the staged codecs
    fused: bool = True
    # the fault schedule (a TieredFaultPlan on the hierarchical
    # topology); None = the reliable network
    fault_plan: Optional[object] = None
    # delayed mixing: mix the previous round's in-flight payload
    overlap: bool = False
    # hierarchical: G = n_pods x pod_size (0 = not hierarchical), the tier
    # topologies and the cross-tier codec (None -> each stream's own)
    n_pods: int = 0
    intra_topology: str = "ring"
    inter_topology: str = "push_sum"
    inter_codec: Optional[codecs_mod.Codec] = None

    @property
    def mcodec(self) -> codecs_mod.Codec:
        return self.moment_codec if self.moment_codec is not None else _FP32

    @property
    def hierarchical(self) -> bool:
        return self.topology == "hierarchical"

    @property
    def pod_len(self) -> int:
        """Members per pod (the validated tier factoring)."""
        return topo_mod.pod_size(self.n_groups, self.n_pods)

    @property
    def intra_plan(self) -> Optional[faults_mod.FaultPlan]:
        p = self.fault_plan
        return p.intra if isinstance(p, faults_mod.TieredFaultPlan) else None

    @property
    def inter_plan(self) -> Optional[faults_mod.FaultPlan]:
        p = self.fault_plan
        return p.inter if isinstance(p, faults_mod.TieredFaultPlan) else None

    def inter_stream_codec(self, stream: str) -> codecs_mod.Codec:
        """The codec a stream crosses the pods with: ``inter_codec`` when
        set, else the stream's own."""
        return (self.inter_codec if self.inter_codec is not None
                else self.stream_codec(stream))

    @property
    def faulty(self) -> bool:
        """True when a fault plan is active on a topology with a wire."""
        return self.fault_plan is not None and self.topology != "none"

    @property
    def delivery_rate(self) -> float:
        """Expected fraction of transmissions delivered per round (1.0 on
        the reliable network)."""
        return (self.fault_plan.expected_delivery
                if self.fault_plan is not None else 1.0)

    @property
    def delivery_rate_intra(self) -> float:
        """The pod-internal tier's delivery rate; a flat topology is one
        tier, so there it is ``delivery_rate``."""
        if not self.hierarchical:
            return self.delivery_rate
        p = self.fault_plan
        return (p.expected_delivery_intra
                if isinstance(p, faults_mod.TieredFaultPlan) else 1.0)

    @property
    def delivery_rate_inter(self) -> float:
        """The cross-pod tier's delivery rate (1.0 on a flat topology)."""
        if not self.hierarchical:
            return 1.0
        p = self.fault_plan
        return (p.expected_delivery_inter
                if isinstance(p, faults_mod.TieredFaultPlan) else 1.0)

    @property
    def p2p(self) -> bool:
        """Explicit-W mixing and push_sum: one edge payload is the
        sender's uplink and the receiver's downlink, counted once."""
        return self.w is not None or self.topology == "push_sum"

    @property
    def lossy_downlink(self) -> bool:
        return (self.downlink_codec is not None
                and not self.downlink_codec.identity
                and self.w is None
                and self.topology not in ("none", "push_sum",
                                          "hierarchical"))

    def stream_codec(self, stream: str) -> codecs_mod.Codec:
        """params get ``codec``, every moment stream ``moment_codec``."""
        return self.codec if stream == "params" else self.mcodec

    def lossy_stream(self, stream: str) -> bool:
        """True when a codec on ``stream``'s path encodes a round delta
        (its own, or the cross-tier codec of the server inter tier), so
        the round must keep its round-start value."""
        if not self.stream_codec(stream).identity:
            return True
        return (self.hierarchical and self.inter_topology == "server"
                and not self.inter_stream_codec(stream).identity)

    @property
    def name(self) -> str:
        if self.hierarchical:
            base = (f"hier[{self.intra_topology}x{self.n_pods}"
                    f"|{self.inter_topology}]/{self.codec.name}")
        else:
            base = f"{self.topology}/{self.codec.name}"
        if not self.mcodec.identity:
            base += f"+m:{self.mcodec.name}"
        if self.inter_codec is not None:
            base += f"+x:{self.inter_codec.name}"
        if self.downlink_codec is not None:
            base += f"+d:{self.downlink_codec.name}"
        if self.faulty:
            p = self.fault_plan
            if isinstance(p, faults_mod.TieredFaultPlan):
                tags = []
                if p.intra is not None:
                    tags.append(f"i{p.intra.drop_rate:g}@{p.intra.seed}")
                if p.inter is not None:
                    tags.append(f"x{p.inter.drop_rate:g}@{p.inter.seed}")
                base += "+drop[" + ",".join(tags) + "]"
            else:
                base += f"+drop{p.drop_rate:g}@{p.seed}"
        if self.overlap:
            base += "+ov"
        return base

    @property
    def stateful(self) -> bool:
        if self.topology == "none":
            return False     # no wire: the codecs never run, no state
        if self.overlap or self.hierarchical:
            return True      # the in-flight payload; the round counter
        return (self.topology in ("async_stale", "push_sum")
                or self.codec.stateful or self.mcodec.stateful
                or self.lossy_downlink or self.faulty)

    # -- state ------------------------------------------------------------

    def init(self, params_G, moments: Optional[dict] = None) -> dict:
        """Comm state for the params stream and the moment streams
        ``{name: value}`` ({} when the exchange is stateless), each a (G,
        N) buffer or a tree of (G, ...) leaves; the state has the
        reference's structure, leaf for leaf. Staleness buffers, in-flight
        payloads and downlink references are copies, never views of the
        live buffers (which the round updates in place)."""
        state: dict = {}
        if not self.stateful:
            return state
        moments = moments or {}
        cstate = {}
        if self.codec.stateful:
            cstate["params"] = self.codec.init(params_G)
        if self.mcodec.stateful:
            for k, v in moments.items():
                cstate[k] = self.mcodec.init(v)
        if cstate:
            state["codec"] = cstate
        vals = {"params": params_G, **moments}
        if self.overlap:
            # round r mixes what round r-1 put here; the initial params
            # (replicated) make round 0's correction exactly zero
            state["inflight"] = {k: v.clone() for k, v in vals.items()}
        if self.topology == "async_stale" or (self.topology == "server"
                                              and self.faulty):
            # the faulty server keeps async_stale's staleness buffers: a
            # group whose push drops contributes its last delivered one
            state["pushed"] = tree.tree_map(torch.clone, params_G)
            if moments:
                state["pushed_opt"] = {k: tree.tree_map(torch.clone, v)
                                       for k, v in moments.items()}
        if self.topology == "async_stale":
            state["round"] = torch.zeros((), dtype=torch.int32)
        if self.hierarchical:
            ic_state = {}
            for k, v in vals.items():
                ic = self.inter_stream_codec(k)
                if ic.stateful:
                    ic_state["inter:" + k] = ic.init(v)
            if ic_state:
                state.setdefault("codec", {}).update(ic_state)
            if self.inter_topology == "push_sum":
                # pod-level ratio consensus: flat push_sum's counters
                # with one backlog slot per pod-graph offset, at G-leading
                # shape (each member lane carries 1/pod_size of its pod)
                self._init_push_sum(state, vals,
                                    topo_mod.push_sum_offsets(self.n_pods))
            state["round"] = torch.zeros((), dtype=torch.int32)
            for k in ("participation", "participation_intra",
                      "participation_inter"):
                state[k] = _f32(1.0)
            return state
        if self.topology == "push_sum":
            self._init_push_sum(state, vals,
                                topo_mod.push_sum_offsets(self.n_groups))
        if self.faulty or self.topology == "push_sum":
            # the masks are pure in (round, seed): the counter in the comm
            # state is what lets a checkpoint resume replay them
            state.setdefault("round", torch.zeros((), dtype=torch.int32))
            state["participation"] = _f32(1.0)
        if self.lossy_downlink:
            # the last decoded broadcast, shared by every group: starts at
            # the G-mean (equal to the params when they start replicated)
            def dinit(v):
                return {"ref": tree.tree_map(
                            lambda a: a.mean(dim=0, keepdim=True).expand_as(
                                a) + 0.0, v),
                        "state": self.downlink_codec.init(v)}

            state["down"] = {k: dinit(v) for k, v in vals.items()}
        return state

    def _init_push_sum(self, state, vals, offs) -> None:
        """Mass counters (host) and per-edge value backlogs (beside the
        streams; per leaf of a tree stream, with a leading offset axis).
        Invariant: sum(mass) + sum(backlog_w) == G to float32 precision,
        every round."""
        def zeros(a):
            return torch.zeros((len(offs),) + tuple(a.shape),
                               dtype=torch.float32, device=a.device)

        state["mass"] = torch.ones((self.n_groups,), dtype=torch.float32)
        state["backlog"] = {k: tree.tree_map(zeros, v)
                            for k, v in vals.items()}
        state["backlog_w"] = torch.zeros((len(offs), self.n_groups),
                                         dtype=torch.float32)

    # -- mixing -----------------------------------------------------------

    def _w_on(self, device) -> torch.Tensor:
        return torch.as_tensor(np.asarray(self.w, np.float32), device=device)

    def mix(self, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """Codec-free mixing over the G axis, written into ``out`` (which
        may be ``x`` itself). Returns ``out``."""
        if self.topology == "none":
            return out.copy_(x) if out is not x else out
        if self.w is None:         # exact mean, broadcast back
            return out.copy_(x.mean(dim=0, keepdim=True).expand_as(x))
        w = self._w_on(x.device)
        y = x
        for _ in range(self.mix_rounds):
            y = _tensordot_w(w, y)
        return out.copy_(y)

    def _mix_into(self, v, out):
        """``mix`` of a stream's value into ``out`` (its live buffer or
        tree, which may be ``v`` itself), leaf by leaf. Returns the mixed
        value."""
        if v is out:
            return _each_leaf(lambda a: self.mix(a, out=a), v)
        return _each_leaf(lambda a, o: self.mix(a, out=o), v, out)

    def check_tree(self, average_opt_state: bool = True) -> None:
        """Refuse what the pytree round cannot run, as the reference
        does: a flat-only codec (int8, int8z, top-k) on a stream that goes
        on the wire, and overlap."""
        if self.topology != "none":
            # ("none" is exempt: nothing goes on the wire, the codecs
            # never run)
            used = [("params", self.codec)]
            if average_opt_state:
                used.append(("moment", self.mcodec))
            if self.downlink_codec is not None:
                used.append(("downlink", self.downlink_codec))
            for what, codec in used:
                if codec.name in _FLAT_ONLY:
                    raise NotImplementedError(
                        f"{what} codec {codec.name!r} needs the packed (G, "
                        "N) buffer as its wire format — run the round with "
                        "a packing.Layout and a packed optimizer (DESIGN.md "
                        "§8)")
        if self.overlap:
            raise NotImplementedError(
                "the overlapped (delayed-mixing) exchange double-buffers "
                "the packed flat stream payload as comm['inflight'] — run "
                "the round with a packing.Layout and a packed optimizer "
                "(DESIGN.md §14); the pytree path has no single "
                "donation-safe buffer to put in flight")

    def _masked_hop(self, v, wm, deficit, act):
        """One masked W hop: a receiver substitutes its own value for
        every lost payload (the deficit keeps rows stochastic) and a
        stalled receiver keeps its value."""
        out = _tensordot_w(wm, v) + deficit[:, None] * v
        return torch.where(act > 0, out, v)

    def _hop_masks(self, rnd: int, hop: int, device):
        """The masked W of one hop and its row deficit, on ``device``."""
        wm = self._w_on(device) * torch.as_tensor(
            self.fault_plan.matrix_mask(rnd, hop, self.n_groups),
            device=device)
        return wm, 1.0 - wm.sum(dim=1)

    def _fault_hops(self, rnd: int, device):
        """A faulty ring/gossip round's masks: the (G, 1) liveness column
        and each hop's ``_hop_masks``, made once a round and shared by
        every stream and leaf (one physical transmission carries them
        all). Returns ``(act, hops)``."""
        act = _col(self.fault_plan.active_mask(rnd, self.n_groups), device)
        return act, [self._hop_masks(rnd, h, device)
                     for h in range(self.mix_rounds)]

    def _mix_faulty(self, x, act, hops, out):
        """ring/gossip under a FaultPlan, written into ``out``, the hops
        masked by ``_fault_hops``. Self-substitution keeps the masked
        matrix row-stochastic but its columns no longer sum to 1, so the
        G-mean drifts (DESIGN.md §12)."""
        y = x
        for wm, deficit in hops:
            y = self._masked_hop(y, wm, deficit, act)
        return out.copy_(y)

    def _edge_participation(self, rnd: int) -> torch.Tensor:
        """Fraction of this round's true edge transmissions (off-diagonal
        W support) delivered, averaged over hops."""
        G = self.n_groups
        sup = ((np.asarray(self.w) > 0) & ~np.eye(G, dtype=bool)).astype(
            np.float32)
        tot = np.float32(max(float(sup.sum()), 1.0))
        total = np.float32(0)
        for h in range(self.mix_rounds):
            m = self.fault_plan.matrix_mask(rnd, h, G)
            total = total + np.float32((m * sup).sum(dtype=np.float32)) / tot
        return _f32(total / np.float32(self.mix_rounds))

    # -- the communication step -------------------------------------------

    def _decentral_lossy(self, x_G, x0_G, cstate, codec, faults=None):
        """ring/gossip with a staged lossy codec: every hop encodes the
        delta against the last transmitted (decoded) value (hop 0 against
        the round start) and mixes the decoded payload; with ``faults``
        (the round's ``_fault_hops``) each hop is masked as the identity
        streams' hops are. Returns (mixed, codec_state)."""
        w = self._w_on(_device(x_G)) if faults is None else None
        y, ref = x_G, x0_G
        for h in range(self.mix_rounds):
            delta_hat, cstate = codec.compress(
                tree.tree_map(torch.sub, y, ref), cstate)
            ref = tree.tree_map(torch.add, ref, delta_hat)
            del delta_hat
            if faults is None:
                y = _each_leaf(lambda v: _tensordot_w(w, v), ref)
            else:
                act, hops = faults
                y = _each_leaf(
                    lambda v: self._masked_hop(v, *hops[h], act), ref)
        return y, cstate

    def _fusable(self, codec, x) -> bool:
        """Streams the fused codec_mix epilogue covers: a (G, N) buffer
        through a width codec on server, ring or gossip, or top-k on
        server (ring/gossip re-select per hop and stay staged). async
        keeps the staged path (the staleness mask interleaves), and so
        does every stream under an active fault plan (the masks
        interleave with the mixing); a tree stream has no flat wire
        format."""
        if self.faulty or not self.fused:
            return False
        if not (isinstance(x, torch.Tensor) and x.dim() == 2):
            return False
        if codec.topk_frac > 0:
            return self.topology == "server"
        return (codec.name in ("int8", "fp16", "bf16")
                and self.topology in ("server", "ring", "gossip"))

    def _fused_stream(self, codec, x, x0, cstate):
        """One stream through codec_mix, mixed into ``x`` in place. The
        top-k threshold tau (the k-th largest |c| of each row) is found
        outside the kernel, as in the reference; int8's noise is drawn
        here at the staged rows shape, one slice per hop, the counter
        advancing by the hop count."""
        if codec.topk_frac > 0:          # server top-k (mean mixing)
            res = cstate["residual"]
            c = (x - x0) + res
            k = max(1, int(round(codec.topk_frac * x.shape[-1])))
            tau = torch.topk(c.abs(), k, dim=-1,
                             sorted=False).values.amin(dim=-1, keepdim=True)
            del c
            mixed, res_out = codec_mix(x, x0, kind="thresh", residual=res,
                                       tau=tau, out=x, residual_out=res,
                                       impl=codec.impl)
            return mixed, {"residual": res_out}
        hops = self.mix_rounds if self.w is not None else 1
        u, new_state = None, cstate
        if codec.chunk > 0:
            g, n = x.shape
            rows_shape = (g * math.ceil(n / codec.chunk), codec.chunk)
            us = [codec.noise(int(cstate["count"]) + h, rows_shape,
                              x.device) for h in range(hops)]
            u = us[0][None] if hops == 1 else torch.stack(us)
            del us
            new_state = {"count": cstate["count"] + hops}
        mixed, _ = codec_mix(x, x0, kind=codec.name, u=u, w=self.w,
                             hops=hops, chunk=codec.chunk, out=x,
                             impl=codec.impl)
        return mixed, new_state

    def streams(self, xs: dict, xs0: dict, comm_state: dict):
        """One exchange of the round's multi-stream payload. ``xs`` maps a
        stream name to its value after the local steps, a (G, N) buffer
        or a tree of (G, ...) tensors; ``xs0`` holds the round-start value
        of every lossy stream. Returns ``(mixed: {name: value},
        new_comm_state)``; a mixed value may be the ``xs`` buffer itself,
        updated in place."""
        if (isinstance(self.fault_plan, faults_mod.TieredFaultPlan)
                and not self.hierarchical):
            raise NotImplementedError(
                f"topology {self.topology!r} is single-tier — a "
                "TieredFaultPlan has no intra/inter split to bind to; "
                "the only valid tiered-fault topology is 'hierarchical'. "
                "Flat topologies take a plain FaultPlan: 'server', "
                "'ring', 'gossip', 'async_stale', 'push_sum'")
        if self.hierarchical:
            return self._hier_streams(xs, xs0, comm_state)
        if self.topology == "push_sum":
            return self._push_sum_streams(xs, comm_state)
        plan = self.fault_plan if self.topology != "none" else None
        rnd = None if plan is None else int(comm_state["round"])
        dev = _device(xs["params"])
        # faulty ring/gossip: the round's hop masks, shared by every stream
        faults = (self._fault_hops(rnd, dev)
                  if plan is not None and self.w is not None else None)
        new_state = dict(comm_state)
        cstates = dict(comm_state.get("codec", {}))
        touched = False
        x_hat, d_hats, mixed = {}, {}, {}
        for name, x in xs.items():
            codec = self.stream_codec(name)
            if codec.identity or self.topology == "none":
                # "none" skips the codec too: nothing goes on the wire
                x_hat[name] = x
                continue
            if self._fusable(codec, x):
                mixed[name], cs = self._fused_stream(
                    codec, x, xs0[name], cstates.get(name, {}))
            elif self.w is not None:
                # decentralized + lossy: the codec runs per mixing hop
                mixed[name], cs = self._decentral_lossy(
                    x, xs0[name], cstates.get(name, {}), codec, faults)
            else:
                d_hat, cs = codec.compress(
                    tree.tree_map(torch.sub, x, xs0[name]),
                    cstates.get(name, {}))
                x_hat[name] = tree.tree_map(torch.add, xs0[name], d_hat)
                if plan is not None and "residual" in cs:
                    d_hats[name] = d_hat      # deferred if the push drops
                del d_hat
            if codec.stateful:
                cstates[name] = cs
                touched = True
        if faults is not None:
            # faulty ring/gossip: masked hops for the identity streams
            # (the lossy ones were masked per hop above)
            mixed.update({k: _each_leaf(
                lambda a, o: self._mix_faulty(a, *faults, out=o), v, xs[k])
                for k, v in x_hat.items()})
            if touched:
                new_state["codec"] = cstates
            new_state["round"] = comm_state["round"] + 1
            new_state["participation"] = self._edge_participation(rnd)
            return mixed, new_state
        if self.topology != "async_stale" and plan is None:
            if touched:
                new_state["codec"] = cstates
            mixed.update({k: self._mix_into(v, xs[k])
                          for k, v in x_hat.items()})
            return self._apply_downlink(mixed, comm_state, new_state)
        # bounded staleness: refresh the groups whose push arrived this
        # round (async_stale's schedule; everyone on the faulty server),
        # average every group's last delivered push, per stream; a
        # dropped push is sent again from the same buffer. The schedule
        # reads the round counter before its increment
        rnd = int(comm_state["round"])
        G = self.n_groups
        if self.topology == "async_stale":
            sched = (np.arange(G) + rnd) % (self.staleness + 1) == 0
        else:
            sched = np.ones((G,), bool)
        if plan is not None:
            delivered = plan.push_mask(rnd, G)
            fresh = sched & (delivered > 0)
            # only faults defer an error-feedback payload (the schedule's
            # own idle rounds drop by design)
            arrived = np.where(sched, delivered, np.float32(1.0))
            for name, d in d_hats.items():
                cstates[name] = codecs_mod.defer_undelivered(
                    cstates[name], d, torch.as_tensor(arrived,
                                                      device=d.device))
                touched = True
            n_sched = np.float32(max(sched.astype(np.float32).sum(), 1.0))
            new_state["participation"] = _f32(
                np.where(sched, delivered, np.float32(0)).sum(
                    dtype=np.float32) / n_sched)
        else:
            fresh = sched
        del d_hats
        if touched:
            new_state["codec"] = cstates
        fresh = torch.as_tensor(fresh[:, None], device=dev)

        def refresh(x, pushed):
            return torch.where(fresh, x, pushed)

        pushed = _each_leaf(refresh, x_hat["params"], comm_state["pushed"])
        new_state["pushed"] = pushed
        mixed["params"] = self._mix_into(pushed, xs["params"])
        mnames = [k for k in x_hat if k != "params"]
        if mnames:
            pushed_opt = dict(comm_state["pushed_opt"])
            for k in mnames:
                pushed_opt[k] = _each_leaf(refresh, x_hat[k], pushed_opt[k])
                mixed[k] = self._mix_into(pushed_opt[k], xs[k])
            new_state["pushed_opt"] = pushed_opt
        new_state["round"] = comm_state["round"] + 1
        return self._apply_downlink(mixed, comm_state, new_state)

    def _push_sum_streams(self, xs: dict, comm_state: dict):
        """Push-sum ratio consensus (DESIGN.md §12). Every live node splits
        a (value, weight) mass pair into ``deg + 1`` equal shares, keeps
        one and pushes one along each circulant offset; the estimate is
        value / weight. Per-edge backlogs make it loss-tolerant: a
        delivered payload carries its edge's whole queue, an undelivered
        one leaves it queued, so mass is conserved under any drop pattern
        (sum(mass) + sum(backlog_w) == G to float32 precision) and the
        ratio stays an unbiased combination of the groups' models. A cast
        codec (fp16/bf16) quantizes the transmitted value; its residue
        stays queued. An absent node's mass freezes and drains on rejoin.
        Each stream's mixed value is written into its ``xs`` buffer. The
        weight channel advances once a round, whatever the leaves."""
        G = self.n_groups
        offs = topo_mod.push_sum_offsets(G)
        for name in xs:
            codec = self.stream_codec(name)
            if not (codec.identity or codec.name in ("fp16", "bf16")):
                raise NotImplementedError(
                    f"push_sum + {codec.name}: the push-sum wire carries "
                    "cumulative (value, weight) mass, not round deltas "
                    "(DESIGN.md §12); valid push_sum codecs: 'fp32', "
                    "'fp16', 'bf16'")
        new_state = dict(comm_state)
        new_state["round"] = comm_state["round"] + 1
        if not offs:                               # G == 1: no wire
            return dict(xs), new_state
        ps = self.push_sum_round(comm_state)
        dev = _device(xs["params"])
        act_d = _col(ps.act, dev)
        masks_d = [[_col(m, dev) for m in mh] for mh in ps.masks]
        incs_d = [[_col(m, dev) for m in ih] for ih in ps.incs]
        w0_d, w_d = _col(ps.w0, dev), _col(ps.w, dev)
        backlog = {k: _own_backlog(v)
                   for k, v in comm_state["backlog"].items()}
        mixed = {}
        for k, x in xs.items():
            codec = self.stream_codec(k)

            def ratio(v, bl):
                num = v.to(torch.float32) * w0_d
                for h in range(self.mix_rounds):
                    num = _push_sum_hop(num, bl, ps.a, act_d, offs,
                                        incs_d[h], masks_d[h], codec)
                return torch.div(num, w_d, out=v)

            mixed[k] = _each_leaf(ratio, x, backlog[k])
        new_state.update(ps.state)
        new_state["backlog"] = backlog
        return mixed, new_state

    def push_sum_round(self, comm_state: dict) -> "PushSumRound":
        """One push-sum round's host side, shared by the replicated and
        the sharded exchange: the liveness, the per-(hop, offset) delivery
        masks and sender columns (one set for every stream of the one
        physical transmission), the weight channel before and after
        (float32 numpy, the reference's ops in its order), and the new
        ``mass``, ``backlog_w`` and ``participation``."""
        G = self.n_groups
        offs = topo_mod.push_sum_offsets(G)
        rnd = int(comm_state["round"])
        plan = self.fault_plan
        a = 1.0 / (len(offs) + 1.0)
        act = (plan.active_mask(rnd, G) if plan is not None
               else np.ones((G,), np.float32))
        masks, incs = [], []
        for h in range(self.mix_rounds):
            mh, ih = [], []
            for di, d in enumerate(offs):
                bern = (plan.edge_mask(rnd, h, di, G) if plan is not None
                        else np.ones((G,), np.float32))
                src = np.roll(act, d)    # sender liveness, receiver slot
                ih.append(src)
                mh.append(bern * src * act)
            masks.append(mh)
            incs.append(ih)
        w0 = comm_state["mass"].numpy()
        w, blw = w0, comm_state["backlog_w"].numpy()
        for h in range(self.mix_rounds):
            w, blw = _push_sum_weights(w, blw, a, act, offs, incs[h],
                                       masks[h])
        total = np.float32(0)
        for mh in masks:
            for m in mh:
                total = total + _mask_mean(m)
        return PushSumRound(offs, a, act, masks, incs, w0, w, {
            "mass": torch.from_numpy(w), "backlog_w": torch.from_numpy(blw),
            "participation": _f32(
                total / np.float32(self.mix_rounds * len(offs)))})

    def check_hier(self, pairs) -> None:
        """The two-tier exchange's refusals, as the reference's, for each
        ``(intra codec, inter codec)`` pair of the streams that cross it: a
        flat FaultPlan (it does not say which tier it masks), an intra
        codec other than a cast, a push_sum inter tier with a codec other
        than a cast."""
        if (self.fault_plan is not None
                and not isinstance(self.fault_plan,
                                   faults_mod.TieredFaultPlan)):
            raise NotImplementedError(
                "hierarchical faults are per-tier: a flat FaultPlan does "
                "not say WHICH tier it masks — wrap it as "
                "faults.TieredFaultPlan(intra=..., inter=...); valid "
                "tiers: 'intra' (pod-internal), 'inter' (cross-pod)")
        for c, ic in pairs:
            if not (c.identity or c.name in ("fp16", "bf16")):
                raise NotImplementedError(
                    f"hierarchical intra tier + {c.name}: pod-internal "
                    "hops carry whole-value payloads, not round deltas "
                    "(DESIGN.md §16); valid intra codecs: 'fp32', "
                    "'fp16', 'bf16' — put int8 on the cross-tier wire "
                    "via inter_codec with inter_topology='server'")
            if self.inter_topology == "push_sum" and not (
                    ic.identity or ic.name in ("fp16", "bf16")):
                raise NotImplementedError(
                    f"hierarchical push_sum inter tier + {ic.name}: the "
                    "cross-pod wire carries cumulative (value, weight) "
                    "mass, not round deltas (DESIGN.md §12/§16); valid "
                    "push_sum inter codecs: 'fp32', 'fp16', 'bf16' — or "
                    "inter_topology='server' for 'int8'")

    def hier_round(self, comm_state: dict) -> "HierRound":
        """One two-tier round's host side, shared by the replicated and
        the sharded exchange: every mask, liveness vector, leader weight
        and the push-sum weight channel at full (G,) shape (float32
        numpy, the reference's ops in its order), and the comm-state
        entries the round sets (``round``, the three participations, and
        push-sum's ``mass`` and ``backlog_w``)."""
        G, n_pods = self.n_groups, self.n_pods
        s = self.pod_len
        ip, xp = self.intra_plan, self.inter_plan
        rnd = int(comm_state["round"])
        ones = np.ones((G,), np.float32)

        def pod_take(x, d):
            # the payload member i receives from pod-mate (i + d) % s
            return np.roll(x.reshape(n_pods, s), -d, axis=1).reshape(-1)

        # ---- stage A: pod-internal tier ------------------------------
        act_i = ip.active_mask(rnd, G) if ip is not None else ones
        part_intra = np.float32(1.0)
        masks_a, deliv, den = [], None, None
        if s > 1 and self.intra_topology == "ring":
            _, offs_pod, _ = topo_mod.ring_circulant(s)
            mask_sum, mask_n = np.float32(0), 0
            for h in range(self.mix_rounds):
                mh = []
                for di, d in enumerate(offs_pod):
                    bern = (ip.edge_mask(rnd, h, di, G) if ip is not None
                            else ones)
                    mh.append(bern * pod_take(act_i, d) * act_i)
                hop_sum = np.float32(0)
                for m in mh:
                    hop_sum = hop_sum + _mask_mean(m)
                mask_sum = mask_sum + hop_sum
                mask_n += len(mh)
                masks_a.append(mh)
            if ip is not None and mask_n:
                part_intra = mask_sum / np.float32(mask_n)
        elif s > 1:                                # intra "server"
            deliv = ip.push_mask(rnd, G) if ip is not None else ones
            den = deliv.reshape(n_pods, s).sum(axis=1, dtype=np.float32)
            if ip is not None:
                part_intra = _mask_mean(deliv)

        # ---- stage B: cross-pod tier ---------------------------------
        offs_p = topo_mod.push_sum_offsets(n_pods)
        state = {}
        act_pod = w0 = w = lead_w = None
        masks, incs, shifts, a = [], [], [], 0.0
        n_live = np.float32(1.0)
        part_inter = np.float32(1.0)
        if self.inter_topology == "push_sum" and offs_p:
            act_x = xp.active_mask(rnd, G) if xp is not None else ones
            _, pod_live = elect_leaders(act_x, n_pods)
            act_pod = np.repeat(pod_live, s)
            a = 1.0 / (len(offs_p) + 1.0)
            shifts = [dp * s for dp in offs_p]
            for di, sh in enumerate(shifts):
                # one Bernoulli per DCN edge per round, drawn per pod on
                # the inter lane and shared by the pod's member lanes
                bern = (xp.edge_mask(rnd, 0, di, n_pods)
                        if xp is not None else np.ones((n_pods,), np.float32))
                src = np.roll(act_pod, sh)
                incs.append(src)
                masks.append(np.repeat(bern, s) * src * act_pod)
            w0 = comm_state["mass"].numpy()
            w, blw = _push_sum_weights(
                w0, comm_state["backlog_w"].numpy(), a, act_pod, shifts,
                incs, masks)
            state["mass"] = torch.from_numpy(w)
            state["backlog_w"] = torch.from_numpy(blw)
            if xp is not None:
                total = np.float32(0)
                for m in masks:
                    total = total + _mask_mean(m)
                part_inter = total / np.float32(len(offs_p))
        elif self.inter_topology == "server":
            act_x = xp.active_mask(rnd, G) if xp is not None else ones
            lead_w, plive = elect_leaders(act_i * act_x, n_pods)
            n_live = np.float32(max(float(plive.sum(dtype=np.float32)), 1.0))
            if ip is not None or xp is not None:
                part_inter = _mask_mean(plive)
        n_is = self._intra_send_count()
        n_xs = self._inter_send_count()
        tot = n_is + n_xs
        state["round"] = comm_state["round"] + 1
        state["participation"] = _f32(
            (part_intra * np.float32(n_is) + part_inter * np.float32(n_xs))
            / np.float32(tot) if tot > 0 else 1.0)
        state["participation_intra"] = _f32(part_intra)
        state["participation_inter"] = _f32(part_inter)
        return HierRound(s, act_i, masks_a, deliv, den, act_pod, a, shifts,
                         masks, incs, w0, w, lead_w, n_live, state)

    def _hier_streams(self, xs: dict, xs0: dict, comm_state: dict):
        """The two-tier round (DESIGN.md §16).

        Stage A, within pods: G reshapes to (n_pods, pod_size).
        ``intra_topology='ring'`` runs ``mix_rounds`` pod-local circulant
        hops (a cast codec quantizes the neighbour payload; under an
        intra FaultPlan a lost payload self-substitutes); ``'server'``
        takes the pod mean (the survivors' mean under faults).

        Stage B, across pods, on the tier's own fault and codec lanes.
        ``inter_topology='push_sum'``: one hop of pod-level ratio
        consensus, the pod graph's offsets striding ``pod_size`` on the G
        axis, every mask drawn per pod and repeated per member; a fully
        partitioned pod runs local rounds and drains its queue on rejoin;
        ``elect_leaders`` keeps a pod live while any member is.
        ``'server'``: each pod's first live member ships its model
        (through ``inter_codec``, as a delta against the round start) and
        every live member receives the leaders' mean.

        Per-tier participation rides the comm state; the overall value
        weights the tiers by their payload counts. Each stream's mixed
        value is written into its ``xs`` buffer. The masks and weights
        are ``hier_round``'s."""
        n_pods = self.n_pods
        self.check_hier([(self.stream_codec(k), self.inter_stream_codec(k))
                         for k in xs])
        hr = self.hier_round(comm_state)
        s = hr.s
        new_state = dict(comm_state)
        dev = _device(xs["params"])

        def pod_take(x, d):
            # the payload member i receives from pod-mate (i + d) % s
            r = x.reshape((n_pods, s) + tuple(x.shape[1:]))
            return torch.roll(r, -d, 1).reshape(x.shape)

        # ---- stage A: pod-internal tier ------------------------------
        act_i_d = _col(hr.act_i, dev)
        ys = {k: tree.tree_map(lambda v: v.to(torch.float32), x)
              for k, x in xs.items()}
        if hr.masks_a:
            w_self, offs_pod, w_edge = topo_mod.ring_circulant(s)
            masks_a = [[_col(m, dev) for m in mh] for mh in hr.masks_a]
            for k in list(ys):
                codec = self.stream_codec(k)

                def ring(v):
                    for mh in masks_a:
                        out = w_self * v
                        for di, d in enumerate(offs_pod):
                            t = pod_take(v, d)
                            if not codec.identity:
                                t = codec.compress(t, {})[0]
                            # m*t + (1-m)*v with a 0/1 mask: the payload
                            # where it arrived, the receiver's own value
                            # where lost
                            t = torch.where(mh[di] > 0, t, v)
                            t.mul_(w_edge)
                            out.add_(t)
                            del t
                        v = torch.where(act_i_d > 0, out, v)
                        del out
                    return v

                ys[k] = _each_leaf(ring, ys[k])
        elif hr.deliv is not None:                 # intra "server"
            dv = hr.deliv.reshape(n_pods, s)
            recv = (hr.act_i.reshape(n_pods, s) > 0) & (hr.den[:, None] > 0)
            dv_d = torch.as_tensor(dv[:, :, None], device=dev)
            den_d = torch.as_tensor(np.maximum(hr.den, np.float32(1))[
                :, None, None], device=dev)
            recv_d = torch.as_tensor(recv[:, :, None], device=dev)
            for k in list(ys):
                codec = self.stream_codec(k)

                def pod_mean(v):
                    r = v.reshape((n_pods, s) + tuple(v.shape[1:]))
                    t = r if codec.identity else codec.compress(r, {})[0]
                    m = (dv_d * t).sum(dim=1, keepdim=True) / den_d
                    del t
                    return torch.where(recv_d, m.expand_as(r), r).reshape(
                        v.shape)

                ys[k] = _each_leaf(pod_mean, ys[k])

        # ---- stage B: cross-pod tier ---------------------------------
        cstates = dict(comm_state.get("codec", {}))
        touched = False
        mixed = {}
        if hr.act_pod is not None:                 # inter push_sum
            act_pod_d = _col(hr.act_pod, dev)
            masks_d = [_col(m, dev) for m in hr.masks]
            incs_d = [_col(m, dev) for m in hr.incs]
            w0_d, w_d = _col(hr.w0, dev), _col(hr.w, dev)
            backlog = {k: _own_backlog(v)
                       for k, v in comm_state["backlog"].items()}
            for k in xs:
                ic = self.inter_stream_codec(k)

                def ratio(y, bl, out):
                    num = _push_sum_hop(y * w0_d, bl, hr.a, act_pod_d,
                                        hr.shifts, incs_d, masks_d, ic)
                    return torch.div(num, w_d, out=out)

                mixed[k] = _each_leaf(ratio, ys.pop(k), backlog[k], xs[k])
            new_state["backlog"] = backlog
        elif self.inter_topology == "push_sum":    # single pod: no DCN
            for k in xs:
                mixed[k] = tree.tree_map(lambda o, y: o.copy_(y), xs[k],
                                         ys.pop(k))
        else:                                      # inter "server"
            lw_d = _col(hr.lead_w, dev)
            for k in xs:
                ic = self.inter_stream_codec(k)
                y = ys.pop(k)
                if not ic.identity:
                    # the cross-tier codec codes the round delta against
                    # the round start, per group (only the leaders' decoded
                    # payloads enter the mean; coding every group keeps
                    # the noise counter's schedule group-independent)
                    key = "inter:" + k
                    x0 = tree.tree_map(lambda v: v.to(torch.float32),
                                       xs0[k])
                    d_hat, cs = ic.compress(tree.tree_map(torch.sub, y, x0),
                                            cstates.get(key, {}))
                    del y
                    y = tree.tree_map(torch.add, x0, d_hat)
                    del d_hat, x0
                    if ic.stateful:
                        cstates[key] = cs
                        touched = True

                def leader_mean(out, v):
                    m = (lw_d * v).sum(dim=0, keepdim=True) / float(
                        hr.n_live)
                    return out.copy_(torch.where(act_i_d > 0,
                                                 m.expand_as(v), v))

                mixed[k] = _each_leaf(leader_mean, xs[k], y)
                del y
        if touched:
            new_state["codec"] = cstates
        new_state.update(hr.state)
        return mixed, new_state

    def _apply_downlink(self, mixed: dict, comm_state: dict,
                        new_state: dict):
        """The compressed broadcast reply: each stream's mean is
        re-encoded once (its rows are identical) as a delta against the
        last decoded broadcast, through the downlink codec; every group
        receives the decoded value."""
        if not self.lossy_downlink:
            return mixed, new_state
        down = dict(comm_state["down"])
        out = {}
        for name, m in mixed.items():
            st = down[name]
            d_hat, cs = self.downlink_codec.compress(
                tree.tree_map(lambda a, r: a[:1] - r[:1], m, st["ref"]),
                st["state"])
            m_hat = tree.tree_map(lambda r, d: r + d.expand_as(r),
                                  st["ref"], d_hat)
            out[name] = tree.tree_map(lambda a, b: a.copy_(b), m, m_hat)
            down[name] = {"ref": m_hat, "state": cs}
        new_state["down"] = down
        return out, new_state

    def params(self, x_G, x0_G, comm_state: dict):
        """One exchange of the params alone (``x0_G`` may be None for an
        identity codec). Returns ``(mixed_x_G, new_comm_state)``."""
        xs0 = {} if x0_G is None else {"params": x0_G}
        mixed, new_state = self.streams({"params": x_G}, xs0, comm_state)
        return mixed["params"], new_state

    # -- overlap: delayed mixing (DESIGN.md §14) ---------------------------

    def encode_streams(self, xs: dict, xs0: dict, comm_state: dict):
        """Encode every stream once, without mixing: what the overlapped
        round puts in flight for the next round to mix. An identity codec
        ships a copy of the value (never a view of the live buffer); a
        lossy one ``x0 + decode(encode(x - x0))``, advancing its codec
        state once. Returns ``({name: payload}, new_comm_state)``."""
        new_state = dict(comm_state)
        cstates = dict(comm_state.get("codec", {}))
        touched = False
        x_hat = {}
        for name, x in xs.items():
            codec = self.stream_codec(name)
            if codec.identity:
                x_hat[name] = x.clone()
                continue
            d_hat, cs = codec.compress(x - xs0[name], cstates.get(name, {}))
            x_hat[name] = xs0[name] + d_hat
            del d_hat
            if codec.stateful:
                cstates[name] = cs
                touched = True
        if touched:
            new_state["codec"] = cstates
        return x_hat, new_state

    def mix_inflight(self, inflight: dict) -> dict:
        """Mix the previous round's decoded in-flight payload, codec-free
        (it was encoded when it shipped), into fresh buffers: the round
        still needs ``inflight`` for its correction ``x + (mix(inflight)
        - inflight)``. With overlap, ring and gossip run one W hop."""
        return {k: self.mix(v, out=torch.empty_like(v))
                for k, v in inflight.items()}

    # -- wire accounting (static: shapes only) ------------------------------

    def senders_per_round(self) -> float:
        """Uplink payloads per round. server: G. ring/gossip: one per
        directed edge per hop. async_stale: G/(s+1), amortized over the
        staleness cycle. push_sum: one per directed edge per hop, priced
        at the delivery rate (a dropped payload moves no bytes; its queued
        mass rides the next delivered payload)."""
        if self.topology == "none":
            return 0.0
        if self.hierarchical:
            return (self._intra_send_count()
                    + self._inter_send_count(delivered=True))
        if self.topology == "server":
            return float(self.n_groups)
        if self.topology == "async_stale":
            return self.n_groups / (self.staleness + 1)
        if self.topology == "push_sum":
            offs = topo_mod.push_sum_offsets(self.n_groups)
            return (len(offs) * self.n_groups * self.mix_rounds
                    * self.delivery_rate)
        return float(topo_mod.n_edge_sends(self.w) * self.mix_rounds)

    def receivers_per_round(self) -> float:
        """Downlink payloads per round: every topology's mirrors its
        uplink count (server broadcasts to all G; p2p edges are
        symmetric; async answers each push)."""
        return self.senders_per_round()

    def _stream_payload_bytes(self, n_params: int,
                              moment_sizes: Optional[Dict[str, int]]
                              ) -> Dict[str, int]:
        """One uplink payload per stream, through the stream's codec (a
        push-sum payload also carries the 4-byte weight counter)."""
        out = {"params": self.codec.wire_bytes(n_params)}
        if self.topology == "push_sum":
            out["params"] += 4
        for k, n in (moment_sizes or {}).items():
            out[k] = self.mcodec.wire_bytes(n)
        return out

    def _downlink_payload_bytes(self, n_params: int,
                                moment_sizes: Optional[Dict[str, int]]
                                ) -> Dict[str, int]:
        """One downlink payload per stream: at the uplink widths, or at
        the downlink codec's width when one is set."""
        if self.downlink_codec is None:
            return self._stream_payload_bytes(n_params, moment_sizes)
        out = {"params": self.downlink_codec.wire_bytes(n_params)}
        for k, n in (moment_sizes or {}).items():
            out[k] = self.downlink_codec.wire_bytes(n)
        return out

    # -- hierarchical per-tier accounting (DESIGN.md §16) ------------------

    def _intra_send_count(self) -> float:
        """Pod-internal uplink payloads per round: one per pod-local
        circulant edge per hop (ring), or one per member (server)."""
        s = self.pod_len
        if s <= 1:
            return 0.0
        if self.intra_topology == "server":
            return float(self.n_groups)
        _, offs_pod, _ = topo_mod.ring_circulant(s)
        return float(self.n_groups * len(offs_pod) * self.mix_rounds)

    def _inter_send_count(self, delivered: bool = False) -> float:
        """Cross-pod uplink payloads per round, carried by the pod
        leaders: one per pod per directed DCN edge (push_sum; priced at
        the tier's delivery rate when ``delivered``), or one per pod
        (server)."""
        if self.inter_topology == "server":
            return float(self.n_pods)
        n = float(len(topo_mod.push_sum_offsets(self.n_pods)) * self.n_pods)
        return n * self.delivery_rate_inter if delivered else n

    def _tier_wire(self, n_params: int,
                   moment_sizes: Optional[Dict[str, int]]):
        """``{"intra"|"inter": {"up"|"down"|"total": {stream: bytes}}}``:
        p2p tiers (intra ring, inter push_sum) count an edge payload once
        in the total; server tiers count the uplink and the reply."""
        iw = {"params": self.codec.wire_bytes(n_params)}
        xw = {"params":
              self.inter_stream_codec("params").wire_bytes(n_params)}
        if self.inter_topology == "push_sum":
            xw["params"] += 4        # the fp32 weight-mass counter
        for k, n in (moment_sizes or {}).items():
            iw[k] = self.mcodec.wire_bytes(n)
            xw[k] = self.inter_stream_codec(k).wire_bytes(n)
        out = {}
        for tier, count, per, p2p in (
                ("intra", self._intra_send_count(), iw,
                 self.intra_topology == "ring"),
                ("inter", self._inter_send_count(delivered=True), xw,
                 self.inter_topology == "push_sum")):
            up = {k: int(round(count * b)) for k, b in per.items()}
            out[tier] = {"up": up, "down": dict(up),
                         "total": (dict(up) if p2p else
                                   {k: 2 * v for k, v in up.items()})}
        return out

    def wire_bytes_by_stream(self, n_params: int,
                             moment_sizes: Optional[Dict[str, int]] = None
                             ) -> Dict[str, int]:
        """Total payload bytes per round, per stream: server/async pushes
        and replies are distinct payloads; a p2p edge payload counts
        once."""
        if self.hierarchical:
            tw = self._tier_wire(n_params, moment_sizes)
            return {k: tw["intra"]["total"][k] + tw["inter"]["total"][k]
                    for k in tw["intra"]["total"]}
        per = self._stream_payload_bytes(n_params, moment_sizes)
        per_dn = self._downlink_payload_bytes(n_params, moment_sizes)
        s, r = self.senders_per_round(), self.receivers_per_round()
        out = {}
        for k, b in per.items():
            up = int(round(s * b))
            out[k] = up if self.p2p else up + int(round(r * per_dn[k]))
        return out

    def wire_bytes_up(self, n_params: int, *,
                      moment_sizes: Optional[Dict[str, int]] = None) -> int:
        if self.hierarchical:
            tw = self._tier_wire(n_params, moment_sizes)
            return sum(sum(tw[t]["up"].values()) for t in ("intra", "inter"))
        s = self.senders_per_round()
        return sum(int(round(s * b)) for b in
                   self._stream_payload_bytes(n_params, moment_sizes).values())

    def wire_bytes_down(self, n_params: int, *,
                        moment_sizes: Optional[Dict[str, int]] = None) -> int:
        if self.hierarchical:
            tw = self._tier_wire(n_params, moment_sizes)
            return sum(sum(tw[t]["down"].values())
                       for t in ("intra", "inter"))
        r = self.receivers_per_round()
        return sum(int(round(r * b)) for b in self._downlink_payload_bytes(
            n_params, moment_sizes).values())

    def wire_bytes_per_round(self, n_params: int, *,
                             moment_sizes: Optional[Dict[str, int]] = None
                             ) -> int:
        return sum(self.wire_bytes_by_stream(n_params, moment_sizes).values())

    def wire_bytes_by_tier(self, n_params: int,
                           moment_sizes: Optional[Dict[str, int]] = None
                           ) -> Dict[str, int]:
        """Total bytes per round per tier. A flat topology is one tier:
        the whole wire is ``intra``."""
        if not self.hierarchical:
            return {"intra": self.wire_bytes_per_round(
                        n_params, moment_sizes=moment_sizes),
                    "inter": 0}
        tw = self._tier_wire(n_params, moment_sizes)
        return {t: sum(tw[t]["total"].values()) for t in ("intra", "inter")}


def get_exchange(topology: str = "server", codec: str = "fp32",
                 n_groups: int = 1, *, mix_rounds: int = 1,
                 staleness: int = 1, seed: int = 0, impl: str = "auto",
                 chunk: int = 256, topk_frac: float = 0.05,
                 moment_codec: str = "fp32", downlink_codec: str = "",
                 fused: bool = True, drop_rate: float = 0.0,
                 stall_rate: float = 0.0, fault_seed: int = 0,
                 dropouts=(), overlap: bool = False, n_pods: int = 0,
                 intra_topology: str = "ring",
                 inter_topology: str = "push_sum", inter_codec: str = "",
                 intra_drop_rate: float = 0.0, intra_stall_rate: float = 0.0,
                 noise_hook: Optional[Callable] = None) -> Exchange:
    """Build an Exchange from names (the launcher's ``--comm``,
    ``--codec``, ``--moment-codec``, ``--downlink-codec``, ``--drop-rate``,
    ``--stall-rate``, ``--fault-seed``, ``--overlap``, ``--n-pods``,
    ``--intra-topology``, ``--inter-topology``, ``--inter-codec``,
    ``--intra-drop-rate`` and ``--intra-stall-rate`` flags), with the
    reference's refusals, each naming the valid alternatives.

    All-zero fault flags attach no plan. On the hierarchical topology the
    generic ``drop_rate``/``stall_rate``/``dropouts`` describe the lossy
    cross-pod tier and ``intra_*`` the pod-internal one, on independent
    seed lanes of ``fault_seed`` (``faults.fault_seed_for``). The params,
    moment, downlink and cross-tier codecs draw noise from the seed lanes
    of ``faults.codec_seed``. ``noise_hook(seed) -> noise_fn`` (optional)
    gives each int8/int8z codec the noise function of its lane, in place
    of the default generator."""
    if topology not in TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}: valid "
                         f"topologies are {TOPOLOGIES}")
    hier = topology == "hierarchical"
    if not hier:
        if n_pods:
            raise ValueError(
                f"n_pods only applies to topology 'hierarchical' (got "
                f"topology={topology!r}); valid flat topologies take no "
                "tier factoring — use 'hierarchical' or drop n_pods")
        if inter_codec:
            raise ValueError(
                "inter_codec only applies to topology 'hierarchical' — "
                "flat topologies have one wire; valid per-stream knobs "
                "there are 'codec', 'moment_codec', 'downlink_codec'")
        if intra_drop_rate or intra_stall_rate:
            raise ValueError(
                "intra_drop_rate/intra_stall_rate only apply to topology "
                "'hierarchical' — a flat topology's single tier is "
                "configured via 'drop_rate'/'stall_rate'")
    if hier:
        topo_mod.pod_size(n_groups, n_pods)    # validates the factoring
        if intra_topology not in INTRA_TOPOLOGIES:
            raise ValueError(
                f"unknown intra_topology {intra_topology!r}: valid "
                f"intra-pod topologies are {INTRA_TOPOLOGIES}")
        if inter_topology not in INTER_TOPOLOGIES:
            raise ValueError(
                f"unknown inter_topology {inter_topology!r}: valid "
                f"cross-pod topologies are {INTER_TOPOLOGIES}")
        if overlap:
            raise NotImplementedError(
                "overlap + hierarchical: the two mixing stages consume "
                "each other's outputs within one round — a "
                "one-round-stale in-flight payload would interleave the "
                "tiers ambiguously (DESIGN.md §16); valid overlap "
                "topologies: 'server', 'ring', 'gossip'")
        if downlink_codec:
            raise NotImplementedError(
                "hierarchical + downlink_codec: the cross-pod reply is "
                "priced per tier already — compress it with "
                "'inter_codec' instead; valid downlink_codec topologies: "
                "'server', 'async_stale'")
        for nm, c in (("codec", codec), ("moment_codec", moment_codec)):
            if c in ("int8", "int8z", "topk"):
                raise NotImplementedError(
                    f"hierarchical + {nm}={c!r}: pod-internal hops carry "
                    "whole-value payloads, not round deltas (DESIGN.md "
                    "§16); valid intra codecs: 'fp32', 'fp16', 'bf16' — "
                    "put int8 on the cross-tier wire via inter_codec "
                    "with inter_topology='server'")
        if inter_codec == "topk":
            raise NotImplementedError(
                "hierarchical + inter_codec='topk': error feedback "
                "against the pod-leader wire has no per-member residual "
                "home (DESIGN.md §16); valid inter codecs: 'fp32', "
                "'fp16', 'bf16', 'int8', 'int8z'")
        if inter_topology == "push_sum" and inter_codec in ("int8",
                                                            "int8z"):
            raise NotImplementedError(
                f"hierarchical push_sum inter tier + {inter_codec!r}: "
                "the cross-pod wire carries cumulative (value, weight) "
                "mass, not round deltas (DESIGN.md §12/§16); valid "
                "push_sum inter codecs: 'fp32', 'fp16', 'bf16' — or "
                "inter_topology='server' for 'int8'")
        if inter_topology == "server" and (drop_rate or stall_rate
                                           or dropouts):
            raise NotImplementedError(
                "hierarchical inter_topology='server' is the "
                "reliable-DCN baseline — it has no mass counters to "
                "conserve dropped payloads with; lossy cross-pod faults "
                "need inter_topology='push_sum', or a flat faulty "
                "'server'")
    if overlap:
        if topology == "none":
            raise NotImplementedError(
                "topology 'none' has no wire, so there is nothing to put "
                "in flight — overlap would double-buffer a payload that "
                "never ships (DESIGN.md §14); valid overlap topologies: "
                "'server', 'ring', 'gossip'")
        if topology == "async_stale":
            raise NotImplementedError(
                "overlap + async_stale: overlap IS bounded staleness "
                "(s=1 delayed mixing on every topology, DESIGN.md §14) — "
                "stacking the per-group staleness schedule on top would "
                "compound the lag ambiguously; use overlap on 'server' "
                "(same semantics, every group one round stale) or plain "
                "async_stale with staleness=1")
        if topology == "push_sum":
            raise NotImplementedError(
                "overlap + push_sum: the mass counters and per-edge "
                "backlogs must update in the SAME step that mixes the "
                "payload (sum(mass) + sum(backlog_w) == G every round, "
                "DESIGN.md §12) — a one-round-stale mix would break mass "
                "conservation; valid overlap topologies: 'server', "
                "'ring', 'gossip'")
        if downlink_codec:
            raise NotImplementedError(
                "overlap + downlink_codec: the downlink re-encodes the "
                "MIXED mean against the last broadcast, but with overlap "
                "the mix happens a round after the encode — the "
                "broadcast reference would be two rounds stale and the "
                "in-flight payload no longer matches what receivers "
                "decode (DESIGN.md §14); drop one of the two, or use "
                "the barrier engine with downlink_codec")
        if mix_rounds != 1 and topology in ("ring", "gossip"):
            raise NotImplementedError(
                "overlap + mix_rounds > 1: a multi-hop round re-encodes "
                "per hop, but the in-flight payload is a SINGLE encoded "
                "buffer — only one codec-free hop can ride it "
                "(DESIGN.md §14); use mix_rounds=1 with overlap, or the "
                "barrier engine for k-hop rounds")
        if drop_rate or stall_rate or dropouts:
            raise NotImplementedError(
                "overlap + fault injection: the fault masks gate the "
                "mixing in the round that SHIPS the payload — with "
                "delayed mixing the drop schedule and the mix are a "
                "round apart, and retry-from-pushed semantics (DESIGN.md "
                "§12) have no in-flight analogue yet; valid overlap "
                "networks are fault-free, or use the barrier engine "
                "with a FaultPlan")
        if codec == "topk" or moment_codec == "topk":
            raise NotImplementedError(
                "overlap + topk: the error-feedback residual re-offers "
                "unshipped mass against a reference that is one round "
                "stale under delayed mixing — the EF loop gain exceeds 1 "
                "at small selection fractions and the run diverges "
                "(DESIGN.md §14 refusal matrix, measured: ring/topk "
                "f=0.05 → inf); valid overlap codecs: 'fp32', 'fp16', "
                "'bf16', 'int8', 'int8z'")
    if downlink_codec:
        if topology in ("ring", "gossip"):
            raise NotImplementedError(
                "ring/gossip edge payloads are symmetric — each edge "
                "transmission IS both one node's uplink and its "
                "neighbor's downlink, so there is no separate downlink "
                "to compress (DESIGN.md §11); valid downlink_codec "
                "topologies: 'server', 'async_stale'")
        if topology == "push_sum":
            raise NotImplementedError(
                "push_sum edge payloads already carry the (value, "
                "weight) mass both ways — there is no broadcast reply "
                "to compress (DESIGN.md §12); valid downlink_codec "
                "topologies: 'server', 'async_stale'")
        if topology == "none":
            raise NotImplementedError(
                "the 'none' topology has no wire; a downlink codec "
                "would compress a broadcast that never happens; valid "
                "downlink_codec topologies: 'server', 'async_stale'")
        if downlink_codec == "topk":
            raise NotImplementedError(
                "topk is not supported as a downlink codec (DESIGN.md "
                "§11); valid downlink codecs: 'fp32', 'fp16', 'bf16', "
                "'int8'")
    if topology == "async_stale" and codec == "topk":
        # the staleness schedule drops non-pushing groups' deltas by
        # design; an error-feedback residual would count them delivered
        raise NotImplementedError(
            "async_stale + topk: error feedback assumes every round's "
            "payload is delivered, but the staleness schedule drops "
            "non-pushing rounds (DESIGN.md §8); valid async_stale "
            "codecs: 'fp32', 'fp16', 'bf16', 'int8', 'int8z'")
    if moment_codec == "topk":
        # moments are re-estimated each step: error feedback would mix
        # rounds-stale moment mass into fresh estimates
        raise NotImplementedError(
            "topk is not supported as a moment codec (DESIGN.md §10): "
            "error feedback would re-offer rounds-stale moment mass; "
            "valid moment codecs: 'fp32', 'fp16', 'bf16', 'int8', "
            "'int8z'")
    if topology == "push_sum":
        # the push-sum wire carries cumulative (value, weight) mass, not
        # round deltas: int8's delta scaling and top-k's error feedback
        # have no delta to code; a cast's residue stays in the backlog
        if codec in ("int8", "int8z", "topk"):
            raise NotImplementedError(
                f"push_sum + {codec}: the push-sum wire carries "
                "cumulative mass, not round deltas (DESIGN.md §12); "
                "valid push_sum codecs: 'fp32', 'fp16', 'bf16'")
        if moment_codec in ("int8", "int8z", "topk"):
            raise NotImplementedError(
                f"push_sum + moment_codec={moment_codec!r}: moment "
                "streams ride the same mass-counter wire (DESIGN.md "
                "§12); valid push_sum moment codecs: 'fp32', 'fp16', "
                "'bf16'")
    plan = None
    dropouts = tuple(tuple(d) for d in dropouts)
    if hier:
        plan = faults_mod.TieredFaultPlan(
            intra=faults_mod.FaultPlan(
                seed=faults_mod.fault_seed_for(fault_seed, "intra"),
                drop_rate=intra_drop_rate, stall_rate=intra_stall_rate),
            inter=faults_mod.FaultPlan(
                seed=faults_mod.fault_seed_for(fault_seed, "inter"),
                drop_rate=drop_rate, stall_rate=stall_rate,
                dropouts=dropouts))
    elif drop_rate or stall_rate or dropouts:
        plan = faults_mod.FaultPlan(seed=fault_seed, drop_rate=drop_rate,
                                    stall_rate=stall_rate, dropouts=dropouts)
    if plan is not None and plan.trivial:
        plan = None                  # reliable: the fault-free path
    if plan is not None and topology == "none":
        raise ValueError(
            "topology 'none' has no wire to drop packets from; valid "
            "fault-injection topologies: 'server', 'ring', 'gossip', "
            "'async_stale', 'push_sum', 'hierarchical'")

    def lane(name, lane_name):
        s = faults_mod.codec_seed(seed, lane_name)
        return codecs_mod.get_codec(
            name, impl=impl, chunk=chunk, topk_frac=topk_frac, seed=s,
            noise_fn=None if noise_hook is None else noise_hook(s))

    c = lane(codec, "params")
    mc = _FP32 if moment_codec == "fp32" else lane(moment_codec, "moments")
    dc = lane(downlink_codec, "downlink") if downlink_codec else None
    xc = lane(inter_codec, "inter") if inter_codec else None
    w = None
    if topology in ("ring", "gossip"):
        w = topo_mod.mixing_matrix(topology, n_groups, seed=seed)
    return Exchange(topology=topology, codec=c, n_groups=n_groups,
                    mix_rounds=mix_rounds,
                    staleness=staleness if topology == "async_stale" else 0,
                    w=w, moment_codec=mc, downlink_codec=dc, fused=fused,
                    fault_plan=plan, overlap=overlap, n_pods=n_pods,
                    intra_topology=intra_topology,
                    inter_topology=inter_topology, inter_codec=xc)


def default_exchange(n_groups: int) -> Exchange:
    """The paper's server step: star mean, uncompressed."""
    return get_exchange("server", "fp32", n_groups)
