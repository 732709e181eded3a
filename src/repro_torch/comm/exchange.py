"""The round's model exchange (counterpart of ``repro/comm/exchange.py``;
DESIGN.md §8, §10, §11): a topology over the G axis, a codec per stream,
and the exact wire accounting.

  server       mean over G, broadcast back (with fp32: the same ops as
               ``average_groups``).
  ring/gossip  neighbour averaging ``x <- W^k x`` with the
               doubly-stochastic W of ``topology.py``, k = ``mix_rounds``.
  async_stale  server averaging with bounded staleness s: in round n only
               the groups with ``(g + n) % (s + 1) == 0`` push; the server
               averages every group's last push.
  none         no communication (W = I, zero wire bytes).

The payload is multi-stream: the params plus one stream per optimizer
moment. ``codec`` applies to the params, ``moment_codec`` to every
moment; each stream keeps its own codec state under
``comm_state["codec"][stream]`` and, for async_stale, its own staleness
buffer (``"pushed"``, ``"pushed_opt"][stream]``). A ``downlink_codec``
re-encodes the server's (or async's) broadcast as a delta against the
last decoded broadcast (``comm_state["down"]``).

Routing, as in the reference (``_fusable``): int8, fp16 and bf16 on
server, ring and gossip, and top-k on server, run the fused ``codec_mix``
kernel (``kernels/exchange_epilogue.py``); int8z, async_stale, top-k on
ring/gossip and the downlink take the staged codecs (int8's core is the
``qdq_int8`` kernel).

The exchange works in place where it can: an fp32 stream and a fused
stream are mixed into the live (G, N) buffer, whose memory the round
owns. push_sum, hierarchical tiers, fault plans and overlap are not
ported yet (ROADMAP.md Queue A item 4); ``get_exchange`` refuses them.

The pytree round's streams are trees with a leading G axis: ``mix_tree``
mixes them leaf by leaf (each leaf viewed as (G, -1)) through the fp32
wire on server, ring, gossip and none, as the reference's staged path
does. ``check_tree`` refuses the rest: int8, int8z and top-k need the
flat buffer (the reference refuses them too), and the tree path's
fp16/bf16 codecs, lossy downlink and async_stale are not ported yet
(ROADMAP.md Queue A item 1b).
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
_NOT_PORTED = "not ported yet (ROADMAP.md Queue A item 4: faults and tiers)"
_TREE_NOT_PORTED = ("not ported yet on the pytree round (ROADMAP.md Queue A "
                    "item 1b: the pytree round's lossy codecs and "
                    "async_stale); run it with a packed layout")
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


@dataclasses.dataclass(frozen=True)
class Exchange:
    topology: str
    codec: codecs_mod.Codec             # the params stream's codec
    n_groups: int
    mix_rounds: int = 1
    staleness: int = 0
    # (G, G) doubly-stochastic mixing matrix; None = exact mean (server,
    # async) or identity (none)
    w: Optional[np.ndarray] = None
    # codec of every moment stream (None -> fp32)
    moment_codec: Optional[codecs_mod.Codec] = None
    # codec of the server/async broadcast reply (None: the idealized
    # broadcast, priced at the uplink widths)
    downlink_codec: Optional[codecs_mod.Codec] = None
    # route int8/fp16/bf16 (and server top-k) streams through the fused
    # codec_mix epilogue; False = the staged codecs
    fused: bool = True

    @property
    def mcodec(self) -> codecs_mod.Codec:
        return self.moment_codec if self.moment_codec is not None else _FP32

    @property
    def delivery_rate(self) -> float:
        return 1.0           # the reliable network

    @property
    def p2p(self) -> bool:
        """Explicit-W mixing: one edge payload is the sender's uplink and
        the receiver's downlink, counted once."""
        return self.w is not None

    @property
    def lossy_downlink(self) -> bool:
        return (self.downlink_codec is not None
                and not self.downlink_codec.identity
                and self.w is None and self.topology != "none")

    def stream_codec(self, stream: str) -> codecs_mod.Codec:
        """params get ``codec``, every moment stream ``moment_codec``."""
        return self.codec if stream == "params" else self.mcodec

    def lossy_stream(self, stream: str) -> bool:
        """True when ``stream``'s codec encodes a round delta, so the
        round must keep its round-start value."""
        return not self.stream_codec(stream).identity

    @property
    def name(self) -> str:
        base = f"{self.topology}/{self.codec.name}"
        if not self.mcodec.identity:
            base += f"+m:{self.mcodec.name}"
        if self.downlink_codec is not None:
            base += f"+d:{self.downlink_codec.name}"
        return base

    @property
    def stateful(self) -> bool:
        if self.topology == "none":
            return False     # no wire: the codecs never run, no state
        return (self.topology == "async_stale" or self.codec.stateful
                or self.mcodec.stateful or self.lossy_downlink)

    # -- state ------------------------------------------------------------

    def init(self, params_G, moments: Optional[dict] = None) -> dict:
        """Comm state for the (G, N) params buffer and the moment streams
        ``{name: (G, N)}`` ({} when the exchange is stateless). Staleness
        buffers and downlink references are copies, never views of the
        live buffers (which the round updates in place)."""
        state: dict = {}
        if not self.stateful:
            return state
        cstate = {}
        if self.codec.stateful:
            cstate["params"] = self.codec.init(params_G)
        if moments and self.mcodec.stateful:
            for k, v in moments.items():
                cstate[k] = self.mcodec.init(v)
        if cstate:
            state["codec"] = cstate
        if self.topology == "async_stale":
            state["pushed"] = params_G.clone()
            if moments:
                state["pushed_opt"] = {k: v.clone()
                                       for k, v in moments.items()}
            state["round"] = torch.zeros((), dtype=torch.int32)
        if self.lossy_downlink:
            # the last decoded broadcast, shared by every group: starts at
            # the G-mean (equal to the params when they start replicated)
            def dinit(v):
                return {"ref": v.mean(dim=0, keepdim=True).expand_as(v)
                        + 0.0,
                        "state": self.downlink_codec.init(v)}

            state["down"] = {"params": dinit(params_G)}
            if moments:
                state["down"].update({k: dinit(v)
                                      for k, v in moments.items()})
        return state

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

    def check_tree(self, average_opt_state: bool = True) -> None:
        """Refuse an exchange the pytree round cannot run: a flat-only
        codec (as the reference does) or what ROADMAP.md Queue A item 1b
        will port (a lossy tree codec or downlink, async_stale)."""
        if self.topology == "none":
            return           # nothing on the wire: the codecs never run
        used = [("params", self.codec)]
        if average_opt_state:
            used.append(("moment", self.mcodec))
        if self.downlink_codec is not None:
            used.append(("downlink", self.downlink_codec))
        for what, codec in used:
            if codec.name in _FLAT_ONLY:
                raise NotImplementedError(
                    f"{what} codec {codec.name!r} needs the packed (G, N) "
                    "buffer as its wire format — run the round with a "
                    "packing.Layout and a packed optimizer (DESIGN.md §8)")
            if not codec.identity:
                raise NotImplementedError(
                    f"{what} codec {codec.name!r} is {_TREE_NOT_PORTED}")
        if self.topology == "async_stale":
            raise NotImplementedError(
                f"topology 'async_stale' is {_TREE_NOT_PORTED}")

    def mix_tree(self, tree_G):
        """Codec-free mixing of a tree whose leaves carry a leading G
        axis, leaf by leaf, in place (each leaf mixed as its (G, -1)
        view). Returns the tree."""
        def leaf(x):
            x2 = x.view(self.n_groups, -1)
            self.mix(x2, out=x2)
            return x

        return tree.tree_map(leaf, tree_G)

    # -- the communication step -------------------------------------------

    def _decentral_lossy(self, x_G, x0_G, cstate, codec):
        """ring/gossip with a staged lossy codec: every hop encodes the
        delta against the last transmitted (decoded) value (hop 0 against
        the round start) and mixes the decoded payload. Returns (mixed,
        codec_state)."""
        w = self._w_on(x_G.device)
        y, ref = x_G, x0_G
        for _ in range(self.mix_rounds):
            delta_hat, cstate = codec.compress(y - ref, cstate)
            ref = ref + delta_hat
            y = _tensordot_w(w, ref)
        return y, cstate

    def _fusable(self, codec) -> bool:
        """Streams the fused codec_mix epilogue covers: a width codec on
        server, ring or gossip, or top-k on server (ring/gossip re-select
        per hop and stay staged). async keeps the staged path (the
        staleness mask interleaves)."""
        if not self.fused:
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
        stream name to its (G, N) value after the local steps; ``xs0``
        holds the round-start value of every lossy stream. Returns
        ``(mixed: {name: (G, N)}, new_comm_state)``; a mixed value may be
        the ``xs`` buffer itself, updated in place."""
        new_state = dict(comm_state)
        cstates = dict(comm_state.get("codec", {}))
        touched = False
        x_hat, mixed = {}, {}
        for name, x in xs.items():
            codec = self.stream_codec(name)
            if codec.identity or self.topology == "none":
                # "none" skips the codec too: nothing goes on the wire
                x_hat[name] = x
                continue
            if self._fusable(codec):
                mixed[name], cs = self._fused_stream(
                    codec, x, xs0[name], cstates.get(name, {}))
            elif self.w is not None:
                # decentralized + lossy: the codec runs per mixing hop
                mixed[name], cs = self._decentral_lossy(
                    x, xs0[name], cstates.get(name, {}), codec)
            else:
                d_hat, cs = codec.compress(x - xs0[name],
                                           cstates.get(name, {}))
                x_hat[name] = xs0[name] + d_hat
            if codec.stateful:
                cstates[name] = cs
                touched = True
        if touched:
            new_state["codec"] = cstates
        if self.topology != "async_stale":
            mixed.update({k: self.mix(v, out=xs[k])
                          for k, v in x_hat.items()})
            return self._apply_downlink(mixed, comm_state, new_state)
        # bounded staleness: refresh the groups whose push is scheduled
        # this round, average every group's last push, per stream
        rnd = int(comm_state["round"])
        dev = xs["params"].device
        fresh = ((torch.arange(self.n_groups, device=dev) + rnd)
                 % (self.staleness + 1) == 0)[:, None]
        pushed = torch.where(fresh, x_hat["params"], comm_state["pushed"])
        new_state["pushed"] = pushed
        mixed["params"] = self.mix(pushed, out=xs["params"])
        mnames = [k for k in x_hat if k != "params"]
        if mnames:
            pushed_opt = dict(comm_state["pushed_opt"])
            for k in mnames:
                pushed_opt[k] = torch.where(fresh, x_hat[k], pushed_opt[k])
                mixed[k] = self.mix(pushed_opt[k], out=xs[k])
            new_state["pushed_opt"] = pushed_opt
        new_state["round"] = comm_state["round"] + 1
        return self._apply_downlink(mixed, comm_state, new_state)

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
                m[:1] - st["ref"][:1], st["state"])
            m_hat = st["ref"] + d_hat.expand_as(st["ref"])
            out[name] = m.copy_(m_hat)
            down[name] = {"ref": m_hat, "state": cs}
        new_state["down"] = down
        return out, new_state

    # -- wire accounting (static: shapes only) ------------------------------

    def senders_per_round(self) -> float:
        """Uplink payloads per round. server: G. ring/gossip: one per
        directed edge per hop. async_stale: G/(s+1), amortized over the
        staleness cycle."""
        if self.topology == "none":
            return 0.0
        if self.topology == "server":
            return float(self.n_groups)
        if self.topology == "async_stale":
            return self.n_groups / (self.staleness + 1)
        return float(topo_mod.n_edge_sends(self.w) * self.mix_rounds)

    def receivers_per_round(self) -> float:
        """Downlink payloads per round: every topology's mirrors its
        uplink count (server broadcasts to all G; ring/gossip edges are
        symmetric; async answers each push)."""
        return self.senders_per_round()

    def _stream_payload_bytes(self, n_params: int,
                              moment_sizes: Optional[Dict[str, int]]
                              ) -> Dict[str, int]:
        """One uplink payload per stream, through the stream's codec."""
        out = {"params": self.codec.wire_bytes(n_params)}
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

    def wire_bytes_by_stream(self, n_params: int,
                             moment_sizes: Optional[Dict[str, int]] = None
                             ) -> Dict[str, int]:
        """Total payload bytes per round, per stream: server/async pushes
        and replies are distinct payloads; a p2p edge payload counts
        once."""
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
        s = self.senders_per_round()
        return sum(int(round(s * b)) for b in
                   self._stream_payload_bytes(n_params, moment_sizes).values())

    def wire_bytes_down(self, n_params: int, *,
                        moment_sizes: Optional[Dict[str, int]] = None) -> int:
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
        """A flat topology is one tier: the whole wire is ``intra``."""
        return {"intra": self.wire_bytes_per_round(
                    n_params, moment_sizes=moment_sizes),
                "inter": 0}


def get_exchange(topology: str = "server", codec: str = "fp32",
                 n_groups: int = 1, *, mix_rounds: int = 1,
                 staleness: int = 1, seed: int = 0, impl: str = "auto",
                 chunk: int = 256, topk_frac: float = 0.05,
                 moment_codec: str = "fp32", downlink_codec: str = "",
                 fused: bool = True, drop_rate: float = 0.0,
                 stall_rate: float = 0.0, dropouts=(), overlap: bool = False,
                 n_pods: int = 0, inter_codec: str = "",
                 noise_hook: Optional[Callable] = None) -> Exchange:
    """Build an Exchange from names (the ``--comm`` / ``--codec`` /
    ``--moment-codec`` / ``--downlink-codec`` flags), with the reference's
    refusals. The params, moment and downlink codecs draw noise from the
    seed lanes of ``faults.codec_seed``. ``noise_hook(seed) ->
    noise_fn`` (optional) gives each int8/int8z codec the noise function
    of its lane, in place of the default generator."""
    if topology not in TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}: valid "
                         f"topologies are {TOPOLOGIES}")
    if topology in ("push_sum", "hierarchical") or n_pods or inter_codec:
        raise NotImplementedError(
            f"topology {topology!r} (push_sum, hierarchical tiers) is "
            f"{_NOT_PORTED}; ported: 'server', 'ring', 'gossip', "
            "'async_stale', 'none'")
    if overlap:
        raise NotImplementedError(f"overlap is {_NOT_PORTED}")
    if drop_rate or stall_rate or dropouts:
        raise NotImplementedError(f"fault injection is {_NOT_PORTED}")
    if downlink_codec:
        if topology in ("ring", "gossip"):
            raise NotImplementedError(
                "ring/gossip edge payloads are symmetric — each edge "
                "transmission IS both one node's uplink and its "
                "neighbor's downlink, so there is no separate downlink "
                "to compress (DESIGN.md §11); valid downlink_codec "
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

    def lane(name, lane_name):
        s = faults_mod.codec_seed(seed, lane_name)
        return codecs_mod.get_codec(
            name, impl=impl, chunk=chunk, topk_frac=topk_frac, seed=s,
            noise_fn=None if noise_hook is None else noise_hook(s))

    c = lane(codec, "params")
    mc = _FP32 if moment_codec == "fp32" else lane(moment_codec, "moments")
    dc = lane(downlink_codec, "downlink") if downlink_codec else None
    w = None
    if topology in ("ring", "gossip"):
        w = topo_mod.mixing_matrix(topology, n_groups, seed=seed)
    return Exchange(topology=topology, codec=c, n_groups=n_groups,
                    mix_rounds=mix_rounds,
                    staleness=staleness if topology == "async_stale" else 0,
                    w=w, moment_codec=mc, downlink_codec=dc, fused=fused)


def default_exchange(n_groups: int) -> Exchange:
    """The paper's server step: star mean, uncompressed."""
    return get_exchange("server", "fp32", n_groups)
