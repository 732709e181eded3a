"""Observability (counterpart of ``repro/obs/__init__.py``), one schema
for three layers:

* device-side round metrics: the localsgd rounds emit the uniform metric
  block every round (``ROUND_KEYS`` and the per-stream keys);
* host-side phase tracing: ``Trace``/``Trace.phase`` fence before they
  read the clock and write JSONL records (``obs/trace.py``), with the
  calibrated exchange-time split (``exchange_phases``) and a profiler
  dump (``profile_span``);
* reporting: ``python -m repro_torch.obs.report`` summarizes and checks
  a trace file (``obs/report.py``), the port's or the reference's.
"""
from repro_torch.obs.trace import (PhaseTimer, Trace,  # noqa: F401
                                   exchange_phases, profile_span,
                                   to_jsonable)

# bump when the JSONL record layout changes incompatibly; report.py
# refuses to --check traces from a different major schema
SCHEMA_VERSION = 1

# keys present in EVERY localsgd round's metrics dict, every
# configuration (the uniform contract, DESIGN.md §13). Per-stream keys
# ride alongside: wire_bytes/<stream> and codec_err/<stream> for every
# stream the round exchanges (params + averaged moment buffers).
ROUND_KEYS = (
    "loss", "grad_sq", "inner_steps",
    "wire_bytes", "wire_bytes_up", "wire_bytes_down",
    "wire_bytes_intra", "wire_bytes_inter",
    "consensus_sq", "consensus_sq_post",
    "backlog_mass", "participation", "delivery_rate",
    "participation_intra", "participation_inter",
    "delivery_rate_intra", "delivery_rate_inter",
)

# host-measured phase names the launchers emit (checkpoint only appears
# on rounds that save one; the exchange_* pair appears on calibrated
# localsgd runs — trace.exchange_phases, DESIGN.md §14: "exposed" is the
# exchange time on the round's critical path, "total" what the exchange
# costs standalone; overlap efficiency = 1 - exposed/total)
PHASES = ("data", "round", "step", "checkpoint",
          "exchange_exposed", "exchange_total")


def round_metric_keys(streams=("params",)):
    """The full uniform key set for a round exchanging ``streams``."""
    per = tuple(f"wire_bytes/{s}" for s in streams)
    per += tuple(f"codec_err/{s}" for s in streams)
    return ROUND_KEYS + per


def streams_of(metrics) -> tuple:
    """Recover the stream names from a round record's metric keys."""
    return tuple(sorted(k.split("/", 1)[1] for k in metrics
                        if k.startswith("wire_bytes/")))
