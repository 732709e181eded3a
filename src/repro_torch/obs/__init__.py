"""Observability (counterpart of ``repro/obs/__init__.py``): fenced
phase timing and the JSONL trace sink (``obs/trace.py``), in the
reference's record schema, so ``python -m repro.obs.report --check``
reads the port's traces."""
from repro_torch.obs.trace import PhaseTimer, Trace, to_jsonable  # noqa: F401

# the reference's JSONL schema version (repro/obs/__init__.py)
SCHEMA_VERSION = 1
