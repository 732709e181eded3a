"""Phase-fenced tracing: honest wall-clock and a structured JSONL sink
(counterpart of ``repro/obs/trace.py``).

CUDA work returns before it finishes, so a phase timer fences before it
reads the clock: ``torch.cuda.synchronize(device)`` on the device of
every CUDA tensor the phase registered (nothing for CPU tensors). Each
phase is wrapped in ``torch.profiler.record_function`` so a profiler
trace shows the same boundaries as the JSONL records.

Sink format (one JSON object per line), the reference's:

  {"kind": "meta", "schema": 1, ...caller meta...}        # first line
  {"kind": "round"|"step", "round": n, "phase_s": {...}, "metrics": {...}}
  {"kind": ..., ...}                                      # other events

``Trace(path=None)`` is a null sink that still fences and times.
``exchange_phases`` derives the exchange-time split from two calibrated
references, and ``profile_span`` dumps a Chrome trace of a region.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tree


def to_jsonable(x):
    """Metrics -> plain JSON: tensors and arrays become numbers or lists
    (a host copy; callers fence first)."""
    if isinstance(x, dict):
        return {k: to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_jsonable(v) for v in x]
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if hasattr(x, "ndim"):
        a = np.asarray(x)
        if a.ndim == 0:
            return (int(a) if np.issubdtype(a.dtype, np.integer)
                    else float(a))
        return a.astype(float).tolist()
    return float(x)


def _devices(x) -> set:
    """CUDA devices of the tensors in a (nested) result."""
    if isinstance(x, (list, tuple)):
        return set().union(*map(_devices, x)) if x else set()
    if isinstance(x, dict):
        return _devices(tree.leaves(x))
    if isinstance(x, torch.Tensor) and x.is_cuda:
        return {x.device}
    return set()


class PhaseTimer:
    """Fenced wall-clock timer: ``fence(x)`` registers what the phase
    produced; ``__exit__`` synchronizes its CUDA devices, then reads the
    clock."""

    def __init__(self):
        self.seconds = 0.0
        self._fence = None

    def __enter__(self):
        self._fence = None
        self.t0 = time.perf_counter()
        return self

    def fence(self, x):
        self._fence = x
        return x

    __call__ = fence

    def __exit__(self, *exc):
        for dev in _devices(self._fence):
            torch.cuda.synchronize(dev)
        self.seconds = time.perf_counter() - self.t0
        return False


class Trace:
    """Structured trace sink and phase fencing. ``path=None`` keeps the
    fencing and timing and writes nothing. The meta header is written on
    the first record."""

    def __init__(self, path: Optional[str] = None,
                 meta: Optional[Dict[str, Any]] = None):
        self.path = Path(path) if path else None
        self.meta = dict(meta or {})
        self._phases: Dict[str, float] = {}
        self._fh = None
        self.n_records = 0

    @contextlib.contextmanager
    def phase(self, name: str):
        """Fenced, profiler-annotated phase; durations add up under
        ``name`` until the next ``emit_round`` takes them."""
        with torch.profiler.record_function(name):
            with PhaseTimer() as t:
                yield t
        self._phases[name] = self._phases.get(name, 0.0) + t.seconds

    def phase_seconds(self, name: str) -> float:
        """Accumulated seconds of ``name`` since the last emit."""
        return self._phases.get(name, 0.0)

    def add_phase(self, name: str, seconds: float) -> None:
        """Record a duration derived from fenced measurements."""
        self._phases[name] = self._phases.get(name, 0.0) + float(seconds)

    def take_phases(self) -> Dict[str, float]:
        out, self._phases = self._phases, {}
        return out

    def _write(self, rec: dict):
        self.n_records += 1
        if self.path is None:
            return
        if self._fh is None:
            from repro_torch import obs
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "w")
            header = {"kind": "meta", "schema": obs.SCHEMA_VERSION}
            header.update(to_jsonable(self.meta))
            self._fh.write(json.dumps(header) + "\n")
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def emit_round(self, n: int, metrics: Optional[dict] = None,
                   kind: str = "round", **fields) -> dict:
        """One record of the accumulated phase durations and the metrics."""
        rec = {"kind": kind, "round": int(n),
               "phase_s": {k: round(v, 6)
                           for k, v in self.take_phases().items()},
               "metrics": to_jsonable(metrics or {})}
        rec.update(to_jsonable(fields))
        self._write(rec)
        return rec

    def emit(self, kind: str, **fields) -> dict:
        """A free-form event record."""
        rec = {"kind": kind}
        rec.update(to_jsonable(fields))
        self._write(rec)
        return rec

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def exchange_phases(round_s: float, local_ref_s: float, exch_ref_s: float,
                    *, overlap: bool) -> Dict[str, float]:
    """The honest exchange-time split (DESIGN.md §14).

    Fences inside a round cannot separate overlapped phases. Instead the
    launcher calibrates two references ONCE — ``local_ref_s``: the same
    round built with comm='none' (pure local compute), ``exch_ref_s``:
    the exchange's standalone cost (the barrier round less the local
    reference) — and derives per round:

      exchange_exposed = max(0, round_s - local_ref_s)
          the exchange time actually ON the critical path this round;
      exchange_total   = the standalone exchange cost (overlap mode,
          floored at exposed so noise never reports >100% hiding), or
          == exposed for a barrier round (nothing is hidden by
          construction).

    Overlap efficiency = 1 - exposed/total. Where the delayed mixing
    runs in the same CUDA stream as the local steps (the port's round),
    exposed ≈ total and the efficiency is honestly ≈ 0."""
    exposed = max(0.0, float(round_s) - float(local_ref_s))
    total = max(float(exch_ref_s), exposed) if overlap else exposed
    return {"exchange_exposed": exposed, "exchange_total": total}


@contextlib.contextmanager
def profile_span(path: Optional[str], device="cpu"):
    """Wrap a region in ``torch.profiler.profile`` and write its Chrome
    trace (Perfetto and ``chrome://tracing`` open it) as
    ``<path>/profile_<pid>.pt.trace.json``; a no-op when ``path`` is
    falsy. CPU activity always, CUDA activity too when ``device`` is a
    CUDA device: there the profiler must record CUDA activity, or the
    span raises rather than write a trace of the host alone."""
    if not path:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    on_cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_cuda:
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("profile_span: this torch's profiler cannot "
                               "record CUDA activity (no CUPTI)")
        activities.append(ProfilerActivity.CUDA)
    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if on_cuda:
            torch.cuda.synchronize(device)
    if on_cuda and not any(e.device_type == torch.autograd.DeviceType.CUDA
                           for e in prof.events()):
        raise RuntimeError("profile_span: the profiler recorded no CUDA "
                           "activity on " + str(device))
    prof.export_chrome_trace(
        str(out / f"profile_{os.getpid()}.pt.trace.json"))
