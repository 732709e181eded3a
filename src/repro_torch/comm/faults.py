"""Deterministic fault injection for the exchange (counterpart of
``repro/comm/faults.py``; DESIGN.md §12), and the seed-lane registry.

A ``FaultPlan`` is a seeded, replayable unreliable network: per-edge
packet drops (Bernoulli per directed edge per hop), per-round node stalls
(Bernoulli per node) and dropout windows (node g absent for rounds
[r0, r1)). Every mask is a pure function of ``(round, seed)``: a
splitmix32 counter hash over ``(seed, lane, round, hop, sub, index)``,
the reference's uint32 arithmetic bit for bit, so the port's masks equal
the JAX package's and a checkpoint resume replays the same faults (the
round counter rides the comm state).

The masks are tiny ((G,) or (G, G)) and the round counter lives on the
host, so they are made on the host in numpy: the hash in uint64 with
every product taken mod 2^32, the draws converted uint32 -> float32 and
scaled by 2^-32 (both exact or once-rounded, as XLA's convert and
divide), and compared with the rate as a float32, as the reference's
``u >= drop_rate`` compares its weakly typed Python float. The masks are
float32 numpy arrays; the exchange copies each to the card once.

Mask semantics (1.0 = delivered / active, 0.0 = lost / stalled):

* ``edge_mask``    one transmission lane (per hop, per circulant offset).
* ``matrix_mask``  dense (G, G) delivery mask of one W hop; entry [j, i]
                   gates the i -> j payload, a stalled sender's column is
                   0, the diagonal 1.
* ``active_mask``  per-round liveness: stalls and dropout windows.
* ``push_mask``    server-uplink delivery (edge drop x sender liveness).

``TieredFaultPlan`` holds one plan per tier of the hierarchical exchange
(DESIGN.md §16), on the independent seed lanes of ``fault_seed_for``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# The named seed-lane registry. HASH_LANES: the splitmix32 lane constants
# that keep the mask families independent. CODEC_SEED_OFFSETS /
# FAULT_SEED_OFFSETS: each independent rng consumer gets base + offset.
# A new consumer claims a fresh offset in its namespace.
# ---------------------------------------------------------------------------

HASH_LANES = {
    "fault/edge": 1,
    "fault/stall": 2,
    "fault/push": 3,
    "fault/matrix": 4,
}

# offsets on the --seed (codec) base: one per independent codec consumer
CODEC_SEED_OFFSETS = {
    "params": 0,       # the uplink params codec (the base itself)
    "moments": 1,      # every moment stream's codec (DESIGN.md §10)
    "downlink": 2,     # the broadcast-reply codec (DESIGN.md §11)
    "inter": 3,        # the hierarchical cross-tier codec (DESIGN.md §16)
}

# offsets on the --fault-seed base: one per independent fault plan
FAULT_SEED_OFFSETS = {
    "flat": 0,         # a single-tier FaultPlan (the base itself)
    "intra": 1,        # the hierarchical intra-pod (ICI) tier
    "inter": 2,        # the hierarchical cross-pod (DCN) tier
}


def hash_lane(name: str) -> int:
    """The registered splitmix32 hash-lane constant for ``name``."""
    if name not in HASH_LANES:
        raise ValueError(f"unknown hash lane {name!r}: valid lanes are "
                         f"{tuple(HASH_LANES)}")
    return HASH_LANES[name]


def codec_seed(base: int, consumer: str) -> int:
    """The derived seed for a named codec consumer of ``base``."""
    if consumer not in CODEC_SEED_OFFSETS:
        raise ValueError(f"unknown codec seed lane {consumer!r}: valid "
                         f"lanes are {tuple(CODEC_SEED_OFFSETS)}")
    return (base + CODEC_SEED_OFFSETS[consumer]) & 0xFFFFFFFF


def fault_seed_for(base: int, tier: str) -> int:
    """The derived seed for a named fault-plan tier of ``base``."""
    if tier not in FAULT_SEED_OFFSETS:
        raise ValueError(f"unknown fault seed tier {tier!r}: valid "
                         f"tiers are {tuple(FAULT_SEED_OFFSETS)}")
    return (base + FAULT_SEED_OFFSETS[tier]) & 0xFFFFFFFF


_GOLD = 0x9E3779B9          # 2^32 / golden ratio: Weyl-sequence stride
_M32 = 0xFFFFFFFF


def _mix(x):
    """splitmix32 finalizer on uint64 values below 2^32 (or a Python
    int): every product reduced mod 2^32, as the reference's uint32 ops
    wrap."""
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _M32
    return x ^ (x >> 16)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded fault schedule: ``drop_rate`` per-transmission loss,
    ``stall_rate`` per-(round, node) stall probability, ``dropouts`` a
    tuple of ``(g, r0, r1)`` windows during which node g is absent."""
    seed: int = 0
    drop_rate: float = 0.0
    stall_rate: float = 0.0
    dropouts: Tuple[Tuple[int, int, int], ...] = ()

    def __post_init__(self):
        if not 0.0 <= self.drop_rate < 1.0:
            raise ValueError(f"drop_rate {self.drop_rate} not in [0, 1)")
        if not 0.0 <= self.stall_rate < 1.0:
            raise ValueError(f"stall_rate {self.stall_rate} not in [0, 1)")

    @property
    def trivial(self) -> bool:
        """True when the plan injects nothing; ``get_exchange`` attaches
        no plan then, so the fault-free path runs."""
        return (self.drop_rate == 0.0 and self.stall_rate == 0.0
                and not self.dropouts)

    @property
    def expected_delivery(self) -> float:
        """Expected fraction of transmissions delivered per round (what
        ``AdaptiveT.from_exchange`` reprices the comm cost with; dropout
        windows are transient, not priced)."""
        return (1.0 - self.drop_rate) * (1.0 - self.stall_rate) ** 2

    # -- keyed mask primitives (numpy on the host, pure in round) ---------

    def _key(self, lane: int, rnd: int, hop: int = 0, sub: int = 0) -> int:
        """The hash state of the (seed, lane, round, hop, sub) chain."""
        h = self.seed & _M32
        for w in (lane, rnd, hop, sub):
            h = _mix(h ^ (((int(w) & _M32) * _GOLD + 1) & _M32))
        return h

    def _uniform(self, key: int, shape) -> np.ndarray:
        """[0, 1) float32 uniforms, one hash per counter index."""
        n = int(np.prod(shape, dtype=np.int64))
        idx = np.arange(n, dtype=np.uint64)
        bits = _mix(np.uint64(key) ^ ((idx * np.uint64(_GOLD) + np.uint64(1))
                                      & np.uint64(_M32)))
        u = bits.astype(np.uint32).astype(np.float32) / np.float32(2 ** 32)
        return u.reshape(shape)

    def _deliver(self, key: int, shape) -> np.ndarray:
        if self.drop_rate == 0.0:
            return np.ones(shape, np.float32)
        u = self._uniform(key, shape)
        return (u >= np.float32(self.drop_rate)).astype(np.float32)

    def edge_mask(self, rnd: int, hop: int, offset_idx: int,
                  n: int) -> np.ndarray:
        """(n,) delivery mask of one transmission lane: receiver-indexed
        entries of the ``offset_idx``-th circulant offset at ``hop``."""
        return self._deliver(
            self._key(HASH_LANES["fault/edge"], rnd, hop, offset_idx), (n,))

    def matrix_mask(self, rnd: int, hop: int, n: int) -> np.ndarray:
        """(n, n) delivery mask of one dense W hop; [j, i] gates i -> j
        (sender liveness folded in), diagonal pinned to 1."""
        m = self._deliver(self._key(HASH_LANES["fault/matrix"], rnd, hop),
                          (n, n))
        m = m * self.active_mask(rnd, n)[None, :]
        np.fill_diagonal(m, 1.0)
        return m

    def active_mask(self, rnd: int, n: int) -> np.ndarray:
        """(n,) liveness this round: 1 = participating. Stalls are
        Bernoulli per (round, node); dropout windows are static."""
        if self.stall_rate > 0.0:
            u = self._uniform(self._key(HASH_LANES["fault/stall"], rnd),
                              (n,))
            act = (u >= np.float32(self.stall_rate)).astype(np.float32)
        else:
            act = np.ones((n,), np.float32)
        for g, r0, r1 in self.dropouts:
            # a node outside [-n, n) is dropped, as the reference's
            # out-of-bounds ``.at[g].set`` is
            if r0 <= rnd < r1 and -n <= g < n:
                act[g] = 0.0
        return act

    def push_mask(self, rnd: int, n: int) -> np.ndarray:
        """(n,) server-uplink delivery: a stalled or absent node's push
        never leaves it; a live node's push drops at ``drop_rate``."""
        m = self._deliver(self._key(HASH_LANES["fault/push"], rnd), (n,))
        return m * self.active_mask(rnd, n)


@dataclasses.dataclass(frozen=True)
class TieredFaultPlan:
    """Per-tier fault schedule of the hierarchical exchange (DESIGN.md
    §16): ``intra`` masks the pod-internal hops, ``inter`` the cross-pod
    transmissions, each on its own seed lane. A trivial tier is
    normalized to None (a reliable tier); both None is the trivial plan,
    which ``get_exchange`` drops."""
    intra: Optional[FaultPlan] = None
    inter: Optional[FaultPlan] = None

    def __post_init__(self):
        if self.intra is not None and self.intra.trivial:
            object.__setattr__(self, "intra", None)
        if self.inter is not None and self.inter.trivial:
            object.__setattr__(self, "inter", None)

    @property
    def trivial(self) -> bool:
        return self.intra is None and self.inter is None

    @property
    def expected_delivery_intra(self) -> float:
        return 1.0 if self.intra is None else self.intra.expected_delivery

    @property
    def expected_delivery_inter(self) -> float:
        return 1.0 if self.inter is None else self.inter.expected_delivery

    @property
    def expected_delivery(self) -> float:
        """The product of the tier rates (a round's payload crosses
        whichever tiers it touches)."""
        return self.expected_delivery_intra * self.expected_delivery_inter
