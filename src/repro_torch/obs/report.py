"""Trace summarizer / validator (counterpart of ``repro/obs/report.py``,
DESIGN.md §13): reads the port's traces and the reference's alike.

  PYTHONPATH=src python -m repro_torch.obs.report out.jsonl    # summary
  PYTHONPATH=src python -m repro_torch.obs.report out.jsonl --check

``--check`` is the schema gate CI runs on the trace smoke: meta header
present with a compatible schema version, round indices strictly
monotone, every round record carrying the full uniform metric key set
(``obs.round_metric_keys``), fenced phase durations, and the per-stream
wire splits summing exactly to the totals. Exit 1 with a problem list
on any violation.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Tuple

import numpy as np

from repro_torch import obs


def load(path) -> Tuple[dict, List[dict]]:
    """Parse a JSONL trace -> (meta header, records in file order)."""
    meta, records = {}, []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("kind") == "meta" and not meta:
                meta = rec
            else:
                records.append(rec)
    return meta, records


def rounds_of(records) -> List[dict]:
    return [r for r in records if r.get("kind") == "round"]


def steps_of(records) -> List[dict]:
    """kind="step" records: the serve engine's per-scheduler-tick records
    (same phase_s contract as rounds, serve-specific metric keys)."""
    return [r for r in records if r.get("kind") == "step"]


def check(meta: dict, records: List[dict]) -> List[str]:
    """Schema problems (empty list == valid trace)."""
    problems = []
    if not meta:
        problems.append("no meta header record (kind='meta' first line)")
    elif meta.get("schema") != obs.SCHEMA_VERSION:
        problems.append(f"schema {meta.get('schema')!r} != "
                        f"{obs.SCHEMA_VERSION} (this reader)")
    rounds = rounds_of(records)
    steps = steps_of(records)
    if not rounds and not steps:
        problems.append("no round/step records")
    idx = [r.get("round") for r in rounds]
    if idx and any(b <= a for a, b in zip(idx, idx[1:])):
        problems.append(f"round indices not strictly monotone: {idx}")
    sidx = [r.get("round") for r in steps]
    if sidx and any(b <= a for a, b in zip(sidx, sidx[1:])):
        problems.append(f"step indices not strictly monotone: {sidx}")
    for r in steps:
        ph = r.get("phase_s", {})
        if any(v < 0 for v in ph.values()):
            problems.append(f"step {r.get('round')}: bad phase_s {ph}")
            break
    for r in rounds:
        m = r.get("metrics", {})
        required = obs.round_metric_keys(obs.streams_of(m) or ("params",))
        missing = sorted(set(required) - set(m))
        if missing:
            problems.append(f"round {r.get('round')}: missing metric "
                            f"keys {missing}")
            break                      # one report per failure class
    for r in rounds:
        ph = r.get("phase_s", {})
        if not ph or any(v < 0 for v in ph.values()):
            problems.append(f"round {r.get('round')}: bad phase_s {ph}")
            break
    overlap_meta = bool(meta.get("overlap"))
    for r in rounds:
        ph = r.get("phase_s", {})
        has = {"exchange_exposed" in ph, "exchange_total" in ph}
        if has == {True, False}:
            problems.append(
                f"round {r.get('round')}: exchange_exposed/exchange_total "
                "must appear together (obs.exchange_phases emits the "
                f"pair) — got {sorted(ph)}")
            break
        if overlap_meta and has == {False}:
            problems.append(
                f"round {r.get('round')}: overlap run without the "
                "exchange_exposed/exchange_total phase split — the "
                "overlap win is unmeasured (DESIGN.md §14)")
            break
        if (True in has
                and ph["exchange_exposed"] > ph["exchange_total"] + 1e-9):
            problems.append(
                f"round {r.get('round')}: exchange_exposed "
                f"{ph['exchange_exposed']} > exchange_total "
                f"{ph['exchange_total']} (total is floored at exposed)")
            break
    for r in rounds:
        m = r.get("metrics", {})
        split = sum(v for k, v in m.items()
                    if k.startswith("wire_bytes/"))
        if "wire_bytes" in m and int(split) != int(m["wire_bytes"]):
            problems.append(
                f"round {r.get('round')}: wire_bytes {m['wire_bytes']} "
                f"!= sum of per-stream splits {int(split)}")
            break
        up, down = m.get("wire_bytes_up"), m.get("wire_bytes_down")
        ti, tx = m.get("wire_bytes_intra"), m.get("wire_bytes_inter")
        allowed = set()
        if up is not None and down is not None:
            # total == up + down (server/async: distinct payloads) or
            # total == up == down (p2p edges count once) — DESIGN.md §13
            allowed |= {int(up) + int(down), int(up)}
        if ti is not None and tx is not None:
            # the per-tier identity (DESIGN.md §16): hierarchical rounds
            # mix p2p and server pricing across tiers, so the sum of the
            # tier totals is the authoritative decomposition
            allowed.add(int(ti) + int(tx))
        if ("wire_bytes" in m and allowed
                and int(m["wire_bytes"]) not in allowed):
            problems.append(
                f"round {r.get('round')}: wire_bytes {m['wire_bytes']} "
                f"is neither up+down ({up}+{down}), up ({up}), nor "
                f"intra+inter ({ti}+{tx})")
            break
        bad_part = next(
            (k for k in ("participation", "participation_intra",
                         "participation_inter", "delivery_rate",
                         "delivery_rate_intra", "delivery_rate_inter")
             if not 0.0 <= float(m.get(k, 1.0)) <= 1.0), None)
        if bad_part is not None:
            problems.append(f"round {r.get('round')}: {bad_part} "
                            f"{m.get(bad_part)} outside [0, 1]")
            break
    return problems


def _pct(vals, q):
    return float(np.percentile(np.asarray(vals, float), q))


def summarize(meta: dict, records: List[dict]) -> dict:
    """Per-phase p50/p99, wire totals by stream, consensus trajectory,
    participation — the reporting layer of DESIGN.md §13."""
    rounds = rounds_of(records)
    steps = steps_of(records)
    out = {"meta": {k: v for k, v in meta.items() if k != "kind"},
           "n_rounds": len(rounds), "n_steps": len(steps)}
    phases = {}
    for r in rounds + steps:     # serve step phases aggregate identically
        for k, v in r.get("phase_s", {}).items():
            phases.setdefault(k, []).append(float(v))
    out["phase_s"] = {
        k: {"p50": _pct(v, 50), "p99": _pct(v, 99),
            "total": float(np.sum(v)), "n": len(v)}
        for k, v in phases.items()}
    if "exchange_exposed" in phases and "exchange_total" in phases:
        exposed = float(np.sum(phases["exchange_exposed"]))
        total = float(np.sum(phases["exchange_total"]))
        # 1 - exposed/total: the fraction of exchange time the overlap
        # actually hid behind local compute (DESIGN.md §14); 0 on barrier
        # rounds (exposed == total by construction) and honestly ≈ 0 on
        # serial single-core backends
        out["overlap_efficiency"] = (1.0 - exposed / total
                                     if total > 0.0 else 0.0)
    wire = {}
    for r in rounds:
        for k, v in r.get("metrics", {}).items():
            if k.startswith("wire_bytes/"):
                wire[k[len("wire_bytes/"):]] = \
                    wire.get(k[len("wire_bytes/"):], 0) + int(v)
    out["wire_bytes_by_stream"] = wire
    out["wire_bytes_total"] = sum(
        int(r["metrics"].get("wire_bytes", 0)) for r in rounds)
    out["wire_bytes_by_tier"] = {
        t: sum(int(r["metrics"].get(f"wire_bytes_{t}", 0))
               for r in rounds)
        for t in ("intra", "inter")}
    # serve-engine admission counters (DESIGN.md §15/§16): queue depth
    # and FreeList backpressure across the kind="step" records
    queued = [float(r["metrics"]["queued"]) for r in steps
              if "queued" in r.get("metrics", {})]
    if queued:
        serve = {"queued_mean": float(np.mean(queued)),
                 "queued_max": float(max(queued))}
        deferred = [int(r["metrics"].get("deferred_total", 0))
                    for r in steps]
        serve["deferred_total"] = max(deferred) if deferred else 0
        free = [int(r["metrics"]["free_rows"]) for r in steps
                if "free_rows" in r.get("metrics", {})]
        if free:
            serve["free_rows_min"] = min(free)
        out["serve"] = serve
    cons = [float(np.mean(r["metrics"]["consensus_sq"])) for r in rounds
            if "consensus_sq" in r.get("metrics", {})]
    if cons:
        out["consensus_sq"] = {"first": cons[0], "last": cons[-1],
                               "max": max(cons), "trajectory": cons}
    parts = [float(r["metrics"]["participation"]) for r in rounds
             if "participation" in r.get("metrics", {})]
    if parts:
        out["participation"] = {"mean": float(np.mean(parts)),
                                "min": min(parts)}
    losses = [float(np.mean(r["metrics"]["loss"])) for r in rounds
              if "loss" in r.get("metrics", {})]
    if losses:
        out["loss"] = {"first": losses[0], "last": losses[-1]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="JSONL trace file (train.py --trace)")
    ap.add_argument("--check", action="store_true",
                    help="validate the schema; exit 1 on any problem")
    ap.add_argument("--json", action="store_true",
                    help="print the full summary as JSON")
    args = ap.parse_args(argv)
    meta, records = load(args.trace)
    if args.check:
        problems = check(meta, records)
        for p in problems:
            print(f"PROBLEM: {p}")
        if problems:
            return 1
        rounds = rounds_of(records)
        streams = (list(obs.streams_of(rounds[0]["metrics"]))
                   if rounds else [])
        print(f"OK: {len(rounds)} round record(s), "
              f"{len(steps_of(records))} step record(s), "
              f"schema v{meta.get('schema')}, streams {streams}")
        return 0
    s = summarize(meta, records)
    if args.json:
        print(json.dumps(s, indent=1))
        return 0
    print(f"trace: {args.trace}  rounds: {s['n_rounds']}  "
          f"steps: {s['n_steps']}")
    for k, v in s.get("phase_s", {}).items():
        print(f"  phase {k:<12} p50 {v['p50']*1e3:8.1f}ms  "
              f"p99 {v['p99']*1e3:8.1f}ms  total {v['total']:.2f}s")
    if s.get("wire_bytes_by_stream"):
        tot = s["wire_bytes_total"]
        per = ", ".join(f"{k}={v:,}B"
                        for k, v in s["wire_bytes_by_stream"].items())
        print(f"  wire  total {tot:,}B  ({per})")
        tiers = s.get("wire_bytes_by_tier", {})
        if any(tiers.values()):
            print(f"  wire  by tier intra {tiers.get('intra', 0):,}B  "
                  f"inter {tiers.get('inter', 0):,}B")
    if "serve" in s:
        sv = s["serve"]
        line = (f"  serve queued mean {sv['queued_mean']:.1f}  "
                f"max {sv['queued_max']:.0f}  "
                f"deferred total {sv['deferred_total']}")
        if "free_rows_min" in sv:
            line += f"  free rows min {sv['free_rows_min']}"
        print(line)
    if "overlap_efficiency" in s:
        print(f"  overlap efficiency (1 - exposed/total exchange) "
              f"{s['overlap_efficiency']:.3f}")
    if "consensus_sq" in s:
        c = s["consensus_sq"]
        print(f"  consensus ||x_g - mean||^2: first {c['first']:.3e}  "
              f"last {c['last']:.3e}  max {c['max']:.3e}")
    if "participation" in s:
        print(f"  participation mean {s['participation']['mean']:.3f}  "
              f"min {s['participation']['min']:.3f}")
    if "loss" in s:
        print(f"  loss first {s['loss']['first']:.4f}  "
              f"last {s['loss']['last']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
