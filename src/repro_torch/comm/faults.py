"""The codec seed-lane registry (counterpart of ``repro/comm/faults.py``,
``CODEC_SEED_OFFSETS`` and ``codec_seed``).

Every codec that draws rounding noise gets a seed derived from the run's
``--seed`` base by a fixed per-consumer offset, so the params stream,
the moment streams and the downlink codec draw from separate lanes.
``FaultPlan``, ``TieredFaultPlan`` and the splitmix32 fault masks are not
ported yet (ROADMAP.md Queue A item 4).
"""
from __future__ import annotations

# offsets on the --seed (codec) base: one per independent codec consumer
CODEC_SEED_OFFSETS = {
    "params": 0,       # the uplink params codec (the base itself)
    "moments": 1,      # every moment stream's codec (DESIGN.md §10)
    "downlink": 2,     # the broadcast-reply codec (DESIGN.md §11)
    "inter": 3,        # the hierarchical cross-tier codec (DESIGN.md §16)
}


def codec_seed(base: int, consumer: str) -> int:
    """The derived seed for a named codec consumer of ``base``."""
    if consumer not in CODEC_SEED_OFFSETS:
        raise ValueError(f"unknown codec seed lane {consumer!r}: valid "
                         f"lanes are {tuple(CODEC_SEED_OFFSETS)}")
    return (base + CODEC_SEED_OFFSETS[consumer]) & 0xFFFFFFFF
