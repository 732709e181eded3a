"""The round's model exchange (counterpart of ``repro/comm/exchange.py``,
its ``server`` and ``none`` topologies with the ``fp32`` codec).

``server`` is the paper's server step: every stream is replaced by its
float32 mean over the G axis, broadcast back to every group (in place).
``none`` exchanges nothing. The wire accounting is the reference's:
server/fp32 puts G uplink payloads of 4·N bytes and G downlink payloads
of 4·N bytes on the wire per stream. The lossy codecs, ring, gossip,
async_stale, push_sum, hierarchical tiers, faults and overlap are not
ported yet (ROADMAP.md Queue A, comm/codecs.py and comm/exchange.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

_PORTED_TOPOLOGIES = ("server", "none")
_PORTED_CODECS = ("fp32",)
_CODEC_BYTES = {"fp32": 4}


@dataclasses.dataclass(frozen=True)
class Exchange:
    topology: str
    codec: str
    n_groups: int

    @property
    def delivery_rate(self) -> float:
        return 1.0      # the reliable network

    def streams(self, xs: Dict[str, object]) -> None:
        """Exchange every (G, N) stream of ``xs`` in place (the exchanges
        ported so far carry no state between rounds)."""
        if self.topology == "server":
            for x in xs.values():
                x.copy_(x.mean(dim=0, keepdim=True).expand_as(x))

    # -- wire accounting (static: shapes only) ------------------------------

    def senders_per_round(self) -> int:
        return 0 if self.topology == "none" else self.n_groups

    def _payload_bytes(self, n_params: int,
                       moment_sizes: Optional[Dict[str, int]]) -> dict:
        width = _CODEC_BYTES[self.codec]
        out = {"params": width * n_params}
        out.update({k: width * n for k, n in (moment_sizes or {}).items()})
        return out

    def wire_bytes_by_stream(self, n_params: int,
                             moment_sizes: Optional[Dict[str, int]] = None
                             ) -> Dict[str, int]:
        """Per stream: the uplink pushes plus the broadcast replies."""
        s = self.senders_per_round()
        return {k: 2 * s * b
                for k, b in self._payload_bytes(n_params, moment_sizes).items()}

    def wire_bytes_up(self, n_params: int, *,
                      moment_sizes: Optional[Dict[str, int]] = None) -> int:
        s = self.senders_per_round()
        return sum(s * b for b in
                   self._payload_bytes(n_params, moment_sizes).values())

    def wire_bytes_down(self, n_params: int, *,
                        moment_sizes: Optional[Dict[str, int]] = None) -> int:
        # every group receives the broadcast it pushed for
        return self.wire_bytes_up(n_params, moment_sizes=moment_sizes)

    def wire_bytes_by_tier(self, n_params: int,
                           moment_sizes: Optional[Dict[str, int]] = None
                           ) -> Dict[str, int]:
        """A flat topology is one tier: the whole wire is ``intra``."""
        return {"intra": sum(self.wire_bytes_by_stream(
                    n_params, moment_sizes).values()),
                "inter": 0}


def get_exchange(topology: str = "server", codec: str = "fp32",
                 n_groups: int = 1) -> Exchange:
    if topology not in _PORTED_TOPOLOGIES or codec not in _PORTED_CODECS:
        raise NotImplementedError(
            f"exchange {topology}/{codec} is not ported yet: the port has "
            f"topologies {_PORTED_TOPOLOGIES} with codec fp32 (ROADMAP.md "
            "Queue A, comm/codecs.py and comm/exchange.py)")
    return Exchange(topology, codec, n_groups)


def default_exchange(n_groups: int) -> Exchange:
    """The paper's server step: star mean, uncompressed."""
    return get_exchange("server", "fp32", n_groups)
