"""The port's round telemetry against the JAX package's, on the CPU:
the copied schema (``obs/__init__.py``), ``exchange_phases``, the trace
checker and summary (``obs/report.py``) on broken and real traces, the
train launcher's ``--trace``, ``--profile`` and ``--adaptive-t online``,
and the OnlineT headline of ``benchmarks/overlap.py``.

The launcher runs call ``main`` in this process on one intra-op thread
(as ``test_torch_train_cli.py`` does), on the paper-mlp reduction."""
import json
import math
import os
import sys
import types

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import controller as jctl
from repro.obs import report as jreport
from repro_torch import obs
from repro_torch.core import localsgd as tlsgd
from repro_torch.launch import train
from repro_torch.obs import report, trace as trace_mod

ROOT = os.path.join(os.path.dirname(__file__), "..")
BASE = ["--device", "cpu", "--arch", "paper-mlp", "--reduced", "--rounds",
        "2", "--groups", "2", "--t-inner", "2", "--seq", "32"]


def _main(args):
    """The port's launcher in this process: its exit code."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train.main(BASE + args)
        return 0
    except SystemExit as e:
        return e.code
    finally:
        torch.set_num_threads(threads)


# -- the copied definitions -------------------------------------------------


@pytest.mark.parametrize("streams", [("params",), ("params", "m", "v"),
                                     ("params", "m"), ()])
def test_schema_copied_from_reference(streams):
    assert obs.SCHEMA_VERSION == jobs.SCHEMA_VERSION
    assert obs.ROUND_KEYS == jobs.ROUND_KEYS
    assert obs.PHASES == jobs.PHASES
    keys = obs.round_metric_keys(streams)
    assert keys == jobs.round_metric_keys(streams)
    metrics = dict.fromkeys(keys, 1.0)
    assert obs.streams_of(metrics) == jobs.streams_of(metrics)
    assert obs.streams_of(metrics) == tuple(sorted(streams))


@pytest.mark.parametrize("overlap", [False, True])
def test_exchange_phases_matches_reference(overlap):
    grid = (0.0, 1e-6, 0.013, 0.25, 0.5, 1.0, 3.7)
    for round_s in grid:
        for local in grid:
            for exch in grid:
                got = obs.exchange_phases(round_s, local, exch,
                                          overlap=overlap)
                assert got == jobs.exchange_phases(round_s, local, exch,
                                                   overlap=overlap)
                assert 0.0 <= got["exchange_exposed"] <= \
                    got["exchange_total"]


# -- the trace checker on broken traces -------------------------------------

META = {"kind": "meta", "schema": 1}


def _metrics(**kw):
    m = dict.fromkeys(obs.round_metric_keys(("params",)), 1.0)
    m.update({"wire_bytes": 8, "wire_bytes_up": 8, "wire_bytes_down": 8,
              "wire_bytes_intra": 8, "wire_bytes_inter": 0,
              "wire_bytes/params": 8, "participation": 1.0})
    m.update(kw)
    return m


def _round(n=0, phase_s=None, **metrics):
    return {"kind": "round", "round": n,
            "phase_s": {"round": 0.1} if phase_s is None else phase_s,
            "metrics": _metrics(**metrics)}


def _step(n=0, **phase_s):
    return {"kind": "step", "round": n, "phase_s": phase_s or {"step": 0.1},
            "metrics": {"loss": 1.0}}


SPLIT = {"round": 0.1, "exchange_exposed": 0.02, "exchange_total": 0.05}
BAD_TRACES = {
    "valid": (META, [_round(0), _round(1)]),
    "valid_steps": (META, [_step(0), _step(1)]),
    "valid_split_overlap": (dict(META, overlap=True), [_round(0, SPLIT)]),
    "no_meta": ({}, [_round(0)]),
    "wrong_schema": (dict(META, schema=2), [_round(0)]),
    "no_records": (META, []),
    "rounds_not_monotone": (META, [_round(0), _round(0)]),
    "steps_not_monotone": (META, [_step(1), _step(0)]),
    "step_bad_phase": (META, [_step(0, step=-1.0)]),
    "missing_keys": (META, [{"kind": "round", "round": 0,
                             "phase_s": {"round": 0.1},
                             "metrics": {"loss": 1.0}}]),
    "empty_phases": (META, [_round(0, {})]),
    "negative_phase": (META, [_round(0, {"round": -0.1})]),
    "half_pair": (META, [_round(0, {"round": 0.1,
                                    "exchange_exposed": 0.02})]),
    "overlap_without_split": (dict(META, overlap=True), [_round(0)]),
    "exposed_over_total": (META, [_round(0, {"round": 0.1,
                                             "exchange_exposed": 0.9,
                                             "exchange_total": 0.1})]),
    "stream_split_mismatch": (META, [_round(0, wire_bytes=999,
                                            wire_bytes_up=999,
                                            wire_bytes_down=0)]),
    "up_down_mismatch": (META, [_round(0, wire_bytes_up=3,
                                       wire_bytes_down=3,
                                       wire_bytes_intra=3,
                                       wire_bytes_inter=3)]),
    "tier_sum": (META, [_round(0, wire_bytes_up=5, wire_bytes_down=5,
                               wire_bytes_intra=5, wire_bytes_inter=2)]),
    "participation_high": (META, [_round(0, participation=1.5)]),
    "delivery_negative": (META, [_round(0, delivery_rate_inter=-0.1)]),
}


@pytest.mark.parametrize("case", sorted(BAD_TRACES))
def test_check_and_summary_match_reference(case, tmp_path):
    """Each class of problem ``check`` reports, written to a file and read
    back by both packages' ``load``: the same problem list (empty only
    for the valid cases) and the same summary."""
    meta, records = BAD_TRACES[case]
    path = tmp_path / "t.jsonl"
    lines = ([meta] if meta else []) + records
    path.write_text("".join(json.dumps(r) + "\n" for r in lines))
    got, want = report.load(path), jreport.load(path)
    assert got == want
    problems = report.check(*got)
    assert problems == jreport.check(*want)
    assert (problems == []) == case.startswith("valid")
    if records:
        assert report.summarize(*got) == jreport.summarize(*want)
    assert report.main([str(path), "--check"]) == \
        jreport.main([str(path), "--check"])


# -- the launcher's traces ---------------------------------------------------

RUNS = {
    "packed_server": ["--packed"],
    "packed_ring_int8_overlap": ["--packed", "--comm", "ring", "--codec",
                                 "int8", "--overlap"],
    "pytree_push_sum": ["--comm", "push_sum", "--drop-rate", "0.1"],
    "sync": ["--packed", "--mode", "sync"],
}


@pytest.fixture(scope="module")
def launcher_traces(tmp_path_factory):
    """Each RUNS config through the port's launcher with --trace (and
    --checkpoint on the sync run): the trace paths."""
    tmp = tmp_path_factory.mktemp("traces")
    out = {}
    for name, args in RUNS.items():
        out[name] = str(tmp / f"{name}.jsonl")
        extra = (["--checkpoint", str(tmp / "ck")] if name == "sync"
                 else [])
        assert _main(args + ["--trace", out[name]] + extra) == 0, name
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_launcher_trace_passes_both_checks(name, launcher_traces):
    meta, records = report.load(launcher_traces[name])
    assert report.check(meta, records) == []
    assert jreport.check(*jreport.load(launcher_traces[name])) == []
    assert report.summarize(meta, records) == \
        jreport.summarize(meta, records)
    kinds = [r["kind"] for r in records]
    if name == "sync":
        assert kinds == ["step", "step", "checkpoint"]
        assert all(set(r["phase_s"]) == {"data", "step"}
                   for r in records[:2])
        assert records[2]["seconds"] >= 0.0
        return
    assert kinds == ["round", "round"]
    split = {"exchange_exposed", "exchange_total"}
    for r in records:
        ph = r["phase_s"]
        # the pytree round has no calibrated split, as in the reference
        want = {"data", "round"} | (split if meta["packed"] else set())
        assert set(ph) == want, ph
        if meta["packed"]:
            assert ph["exchange_exposed"] <= ph["exchange_total"]
    assert meta["overlap"] == ("overlap" in name)
    assert "overlap_efficiency" in report.summarize(meta, records) or \
        not meta["packed"]


def test_launcher_trace_has_the_reference_structure(launcher_traces,
                                                    tmp_path, monkeypatch):
    """The reference launcher on the same config (packed server fp32):
    the same meta keys, phase names per record, metric keys, round
    indices and wire bytes."""
    from repro.launch import train as jtrain

    path = str(tmp_path / "ref.jsonl")
    monkeypatch.setattr(sys, "argv", ["train"] + BASE[2:] + [
        "--packed", "--trace", path])
    jtrain.main()
    jmeta, jrecs = jreport.load(path)
    meta, recs = report.load(launcher_traces["packed_server"])
    assert list(meta) == list(jmeta)
    assert meta == jmeta
    assert [r["kind"] for r in recs] == [r["kind"] for r in jrecs]
    for r, j in zip(recs, jrecs):
        assert r["round"] == j["round"]
        assert list(r["phase_s"]) == list(j["phase_s"])
        assert sorted(r["metrics"]) == sorted(j["metrics"])
        for k in r["metrics"]:
            if k.startswith("wire_bytes"):
                assert r["metrics"][k] == j["metrics"][k], k


# -- telemetry changes no number ---------------------------------------------


def _spied_run(args, monkeypatch, calibrate):
    """One launcher run: every round record's metrics (through
    ``Trace.emit_round``, which runs with or without --trace) and the
    final state's buffers. ``calibrate=False`` stubs the calibration."""
    records, final = [], {}
    emit = trace_mod.Trace.emit_round

    def spy_emit(self, n, metrics=None, **kw):
        records.append(trace_mod.to_jsonable(metrics))
        return emit(self, n, metrics, **kw)

    server = tlsgd.server_params

    def spy_server(state, layout=None):
        final.update(params=state["params"].clone(), **{
            k: torch.as_tensor(v).clone() for k, v in state["opt"].items()})
        return server(state, layout)

    with monkeypatch.context() as mp:
        mp.setattr(trace_mod.Trace, "emit_round", spy_emit)
        mp.setattr(tlsgd, "server_params", spy_server)
        if not calibrate:
            mp.setattr(train, "calibrate_fences",
                       lambda *a, **k: (0.0, 0.0))
        assert _main(args) == 0
    return records, final


@pytest.mark.parametrize("args", [
    ["--packed", "--opt", "adamw", "--lr", "1e-3", "--codec", "int8",
     "--moment-codec", "int8z"],
    ["--packed", "--comm", "ring", "--codec", "int8", "--overlap",
     "--groups", "4"],
], ids=["adamw_int8z_moments", "ring_int8_overlap"])
def test_telemetry_changes_no_number(args, tmp_path, monkeypatch):
    """With --trace and --profile, and the calibration running on fresh
    states, the params, optimizer state and every round metric are
    bit-equal to the run without them (calibration stubbed): the int8
    noise counters and fault rounds live in the run's own comm state."""
    plain = _spied_run(args, monkeypatch, calibrate=False)
    traced = _spied_run(args + ["--trace", str(tmp_path / "t.jsonl"),
                                "--profile", str(tmp_path / "prof")],
                        monkeypatch, calibrate=True)
    assert plain[0] == traced[0]
    assert set(plain[1]) == set(traced[1])
    for k, v in plain[1].items():
        assert torch.equal(v, traced[1][k]), k
    assert all(math.isfinite(x) for x in plain[0][-1]["loss"])


def test_profile_writes_a_chrome_trace(tmp_path):
    prof = tmp_path / "prof"
    assert _main(["--packed", "--rounds", "1", "--profile", str(prof)]) == 0
    files = list(prof.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "round" for e in events)
    assert any(e.get("name") == "data" for e in events)


# -- the online T controller ------------------------------------------------


def _online_ts(tmp_path, monkeypatch, capsys, extra=(), t_max=None):
    """--adaptive-t online on the packed round: (the T each round ran,
    the T the reference's OnlineT takes fed the same telemetry), read back
    from the trace (trajectory, consensus, codec error, exchange_total)
    and the printed calibration. The fence clock here is quantized to 1/8
    of a unit (at 1000 units a second), so every fenced time and the
    split derived from it survive the trace's 6-digit rounding exactly."""
    clock = trace_mod.time.perf_counter
    monkeypatch.setattr(trace_mod, "time", types.SimpleNamespace(
        perf_counter=lambda: math.floor(clock() * 8000) / 8))
    path = str(tmp_path / "online.jsonl")
    assert _main(["--packed", "--opt", "sgd", "--lr", "0.02",
                  "--adaptive-t", "online", "--trace", path]
                 + list(extra)) == 0
    out = capsys.readouterr().out
    line = next(l for l in out.splitlines() if l.startswith("fences: "))
    local_step = float(line.split()[2])
    meta, recs = report.load(path)
    assert report.check(meta, recs) == []
    ctl = jctl.OnlineT(r=0.01 * meta["delivery_rate"],
                       **({} if t_max is None else {"t_max": t_max}))
    ts = [int(max(r["metrics"]["inner_steps"])) for r in recs]
    want = [2]
    for r in recs:
        m, t_used = r["metrics"], int(max(r["metrics"]["inner_steps"]))
        mean = lambda k: float(torch.tensor(m[k]).mean())  # noqa: E731
        want.append(ctl.update(
            np.asarray(m["grad_sq_traj"][0], np.float32), t_used=t_used,
            local_s=(local_step * t_used) or None,
            exchange_s=r["phase_s"]["exchange_total"] or None,
            consensus_pre=mean("consensus_sq"),
            consensus_post=mean("consensus_sq_post"),
            codec_err=sum(mean(k) for k in m if k.startswith("codec_err/"))))
    return ts, want[:len(ts)]


def test_online_t_follows_the_reference_controller(tmp_path, monkeypatch,
                                                   capsys):
    """The T --adaptive-t online takes each round equals the reference's
    OnlineT fed the same telemetry."""
    ts, want = _online_ts(tmp_path, monkeypatch, capsys)
    assert ts == want
    assert ts[1] != ts[0], ts


def test_online_t_stays_within_t_max(tmp_path, monkeypatch, capsys):
    """--t-max caps the controller's T: every round runs at most the cap,
    the reference's OnlineT with the same cap takes the same T, and the
    uncapped controller asks for more (so the cap is what binds)."""
    free, _ = _online_ts(tmp_path, monkeypatch, capsys)
    cap = max(free[1:]) - 1
    assert cap >= 2, free
    ts, want = _online_ts(tmp_path, monkeypatch, capsys,
                          ["--t-max", str(cap)], t_max=cap)
    assert ts == want
    assert max(ts) == cap and ts[0] == 2, (ts, free)


def test_controller_t_max_caps_a_round_that_fits_no_decay():
    """A round whose gradient norm ends above where it began fits no decay
    order: both packages' OnlineT then ask for their cap of T, 10,000 by
    default, or the cap they were given."""
    from repro_torch.core import controller as tctl
    rising = [5.5, 5.45, 5.5, 5.52, 5.53, 5.55]
    for t_max in (10_000, 16):
        got = tctl.OnlineT(r=0.01, t_max=t_max).update(
            rising, t_used=6, consensus_pre=2.8e-2, consensus_post=0.0)
        want = jctl.OnlineT(r=0.01, t_max=t_max).update(
            rising, t_used=6, consensus_pre=2.8e-2, consensus_post=0.0)
        assert got == want == t_max


# -- the OnlineT headline ---------------------------------------------------


def test_online_t_headline_matches_reference():
    """``chip_smoke.online_t_headline`` on the CPU against the reference's
    ``online_t_section`` at its smoke settings (floor 5e-3, 200 rounds):
    static T*, rounds, local steps, wire totals and distinct T equal; the
    final grad_sq at rtol 1e-5 (the f32 sums run in another order)."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from benchmarks.overlap import online_t_section

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = chip_smoke.online_t_headline(torch, "cpu", floor=5e-3,
                                           max_rounds=200)
    finally:
        torch.set_num_threads(threads)
    want = online_t_section(floor=5e-3, max_rounds=200)
    assert got["t_static"] == want["t_static"]
    for run in ("static", "online"):
        g, w = got[run], want[run]
        for k in ("rounds", "local_steps", "wire_bytes_total",
                  "reached_floor", "distinct_t"):
            assert g[k] == w[k], (run, k)
        assert g["gsq_final"] == pytest.approx(w["gsq_final"], rel=1e-5)
    assert got["wire_ratio_static_over_online"] == \
        want["wire_ratio_static_over_online"]
    assert got["online"]["reached_floor"]
