#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases, in order; any failure raises and the script exits non-zero:

1. the device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. the build: every CUDA C++ kernel of ``src/repro_torch/kernels/csrc``
   compiled with nvcc for sm_90a (one process per source, in parallel);
3. each kernel against its plain PyTorch version on the card, at the main
   path's shape (4, 124,662,528), a ragged (3, 1,000,003) and a few
   tiny ragged shapes, with a row switched off by the ``active`` mask; adamw at counts 1 and 1000 (and
   one count per row) with wd 0 and 0.01. Tolerances: the updates rtol
   1e-6 / atol 1e-7 (they are written to round like the plain version),
   the norm rtol 1e-5 (another summation order) and bit-equal on a rerun.
   Each kernel is timed with CUDA events (median of 20 launches after
   warm-up) beside its bound, its plain version and one PyTorch library
   call that computes the same function (a yardstick the port never
   calls);
4. a small reference check: the packed round on a paper-mlp reduction,
   on the card with the kernels and on the CPU with the plain versions,
   from the same params and batches;
5. the main path at full width: paper-lenet (8 x 768, vocab 32000,
   N = 124,662,528), G = 4, 2 sequences of 128 per group, T = 4, through
   the round builder of ``repro_torch.launch.train``: 3 adamw rounds, one
   sgd and one momentum round, and one adamw round with metrics="traj".
   The launch counters are set to 0 before this phase and read after it;
   each kernel must have been launched the expected number of times;
6. one more adamw round of the main path under ``torch.profiler``: the
   device's busy share of the round and its device time by kernel.

The line before the last is one JSON object with each kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

MAIN = (4, 124_662_528)          # paper-lenet's packed buffer at G = 4
RAGGED = (3, 1_000_003)
# rows shorter than a float4, and rows whose starts fall on every
# alignment: the kernels' ragged head and tail
TINY = ((5, 1), (3, 2), (4, 3), (2, 7), (1, 4099))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_OPS_PER_S = 67e12           # the same, float32 outside tensor cores
EW_TOL = dict(rtol=1e-6, atol=1e-7)
NORM_RTOL = 1e-5

SOURCES = {
    "fused_sgd": ("src/repro_torch/kernels/csrc/fused_update.cu",
                  "src/repro/kernels/fused_sgd.py:28"),
    "fused_momentum": ("src/repro_torch/kernels/csrc/fused_update.cu",
                       "src/repro/kernels/fused_momentum.py:32"),
    "fused_adamw": ("src/repro_torch/kernels/csrc/fused_update.cu",
                    "src/repro/kernels/fused_adamw.py:42"),
    "sq_norm_groups": ("src/repro_torch/kernels/csrc/sq_norm.cu",
                       "src/repro/kernels/sq_norm.py:38"),
}
# bytes moved (each input read once, each output written once) and
# float32 operations, per element of the (G, N) buffer
PER_ELEMENT = {"fused_sgd": (12, 2), "fused_momentum": (20, 4),
               "fused_adamw": (28, 16), "sq_norm_groups": (4, 2)}


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise RuntimeError(msg)


def compare(name, got, want, rtol, atol):
    """Max abs error of got vs want; raise where |got-want| > atol+rtol|want|."""
    diff = (got - want).abs_()
    err = diff.max().item()
    if bool((diff > atol + rtol * want.abs()).any()):
        fail(f"{name}: kernel disagrees with the plain version "
             f"(max abs err {err:.3e}, rtol {rtol}, atol {atol})")
    return err


def time_ms(fn, torch, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(name, shape):
    rows, n = shape
    nbytes, ops = PER_ELEMENT[name]
    byte_ms = nbytes * rows * n / HBM_BYTES_PER_S * 1e3
    op_ms = ops * rows * n / FP32_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def check_kernels(torch, K, ref):
    """Phase 3: every kernel against its plain version, and its times."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {name: {"max_abs_err": 0.0} for name in SOURCES}

    def rand(shape, scale=1.0, positive=False):
        x = torch.randn(shape, generator=gen, device=dev) * scale
        return x.abs_() if positive else x

    def note(name, err):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)

    for shape in (MAIN, RAGGED) + TINY:
        rows = shape[0]
        p, g = rand(shape), rand(shape)
        m, v = rand(shape, 0.1), rand(shape, 0.01, positive=True)
        off = rows // 2
        mask = torch.ones(rows, dtype=torch.bool, device=dev)
        mask[off] = False
        for active in (None, mask):
            tag = f"{shape} " + ("all rows" if active is None
                                 else f"row {off} off")
            # sgd
            kp = p.clone()
            K.fused_sgd.fused_sgd(kp, g, lr=0.05, active=active, impl="cuda")
            wp = p.clone()
            K.fused_sgd.fused_sgd(wp, g, lr=0.05, active=active, impl="torch")
            note("fused_sgd", compare(f"fused_sgd {tag}", kp, wp, **EW_TOL))
            if active is not None and not torch.equal(kp[off], p[off]):
                fail("fused_sgd changed an inactive row")
            del kp, wp
            # momentum
            kp, kmu = p.clone(), m.clone()
            K.fused_momentum.fused_momentum(kp, g, kmu, lr=0.05, beta=0.9,
                                            active=active, impl="cuda")
            wp, wmu = ref.momentum_ref(p, g, m, lr=0.05, beta=0.9)
            if active is not None:
                wp[off], wmu[off] = p[off], m[off]
            note("fused_momentum", max(
                compare(f"fused_momentum p {tag}", kp, wp, **EW_TOL),
                compare(f"fused_momentum mu {tag}", kmu, wmu, **EW_TOL)))
            del kp, kmu, wp, wmu
            # adamw: counts 1 and 1000, one count per row, wd 0 and 0.01
            counts = [torch.tensor(1, device=dev),
                      torch.tensor(1000, device=dev),
                      torch.arange(1, rows + 1, device=dev) * 250]
            for count in counts:
                for wd in (0.0, 0.01):
                    kp, km, kv = p.clone(), m.clone(), v.clone()
                    K.fused_adamw.fused_adamw(kp, g, km, kv, count, lr=1e-3,
                                              wd=wd, active=active,
                                              impl="cuda")
                    bc = ref.adamw_bias_correction(count.expand(rows))
                    want = ref.adamw_ref(p, g, m, v, bc, lr=1e-3, wd=wd)
                    errs = []
                    for label, k, w, old in zip("pmv", (kp, km, kv), want,
                                                (p, m, v)):
                        if active is not None:
                            w[off] = old[off]
                        errs.append(compare(
                            f"fused_adamw {label} {tag} count "
                            f"{count.tolist()} wd {wd}", k, w, **EW_TOL))
                    note("fused_adamw", max(errs))
                    del kp, km, kv, want
        # the norm, twice: the reduction must not depend on block order
        s1 = K.sq_norm.sq_norm_groups(p, impl="cuda")
        s2 = K.sq_norm.sq_norm_groups(p, impl="cuda")
        if not torch.equal(s1, s2):
            fail(f"sq_norm_groups {shape}: two runs differ")
        note("sq_norm_groups", compare(f"sq_norm_groups {shape}", s1,
                                       ref.sq_norm_groups_ref(p),
                                       rtol=NORM_RTOL, atol=0.0))
        log(f"kernels agree with their plain versions at {shape}")

        if shape == MAIN:
            step = torch.tensor(1000.0, device=dev)
            timed = {
                "fused_sgd": (
                    lambda: K.fused_sgd.fused_sgd(p, g, lr=1e-4, impl="cuda"),
                    lambda: ref.sgd_ref(p, g, lr=1e-4),
                    lambda: p.add_(g, alpha=-1e-4)),
                "fused_momentum": (
                    lambda: K.fused_momentum.fused_momentum(
                        p, g, m, lr=1e-4, beta=0.9, impl="cuda"),
                    lambda: ref.momentum_ref(p, g, m, lr=1e-4, beta=0.9),
                    lambda: torch._fused_sgd_(
                        [p], [g], [m], weight_decay=0.0, momentum=0.9,
                        lr=1e-4, dampening=0.0, nesterov=False,
                        maximize=False, is_first_step=False)),
                "fused_adamw": (
                    lambda: K.fused_adamw.fused_adamw(
                        p, g, m, v, step, lr=1e-4, wd=0.01, impl="cuda"),
                    lambda: ref.adamw_ref(p, g, m, v,
                                          ref.adamw_bias_correction(
                                              step.expand(rows)),
                                          lr=1e-4, wd=0.01),
                    lambda: torch._fused_adamw_(
                        [p], [g], [m], [v], [], [step], lr=1e-4, beta1=0.9,
                        beta2=0.999, weight_decay=0.01, eps=1e-8,
                        amsgrad=False, maximize=False)),
                "sq_norm_groups": (
                    lambda: K.sq_norm.sq_norm_groups(p, impl="cuda"),
                    lambda: ref.sq_norm_groups_ref(p),
                    lambda: torch.linalg.vector_norm(p, dim=1)),
            }
            for name, (kern, plain, lib) in timed.items():
                r = results[name]
                r["ms"] = time_ms(kern, torch)
                r["plain_ms"] = time_ms(plain, torch)
                r["library_ms"] = time_ms(lib, torch)
                r["bound_ms"], r["bound_by"] = bound(name, MAIN)
                log(f"{name:15s} kernel_ms {r['ms']:.4f} bound_ms "
                    f"{r['bound_ms']:.4f} ({r['bound_by']}: "
                    f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
                    f"{FP32_OPS_PER_S / 1e12:.0f} TFLOP/s f32, H100 SXM data "
                    f"sheet) plain_ms {r['plain_ms']:.4f} library_ms "
                    f"{r['library_ms']:.4f} max_abs_err {r['max_abs_err']:.3e}")
        del p, g, m, v
        torch.cuda.empty_cache()
    return results


def reference_check(torch):
    """Phase 4: the round with the kernels on the card against the same
    round with the plain versions on the CPU, on a paper-mlp reduction."""
    from repro_torch import optim, tree
    from repro_torch.configs.base import get_config
    from repro_torch.core import localsgd as lsgd
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.models.api import build_model
    from repro_torch.optim import packing

    cfg = get_config("paper-mlp").reduced()
    model = build_model(cfg, schedule="rect")
    params = model.init(torch.Generator().manual_seed(7))
    layout = packing.layout_of(params)
    pipe = TokenPipeline(cfg.vocab_size, 32, seed=7).batches((3, 2))
    batches = [torch.as_tensor(next(pipe)["tokens"]) for _ in range(2)]
    # momentum moves each weight by lr*g; adamw by ~lr whatever |g| is, so
    # its near-zero-gradient weights carry the CPU/GPU matmul differences
    # into their steps at up to ~1e-2 of lr
    for name, lr, t_i, atol in (("momentum", 0.05, None, 1e-6),
                                ("adamw", 1e-3, (1, 3, 2), 1e-4)):
        lcfg = lsgd.LocalSGDConfig(n_groups=3, inner_steps=3, t_i=t_i,
                                   metrics="traj")
        out = {}
        for dev in ("cpu", "cuda"):
            opt = optim.get(name, lr, packed=True)
            rnd = lsgd.make_local_round(model.loss, opt, lcfg, layout=layout)
            state = lsgd.init_state(tree.tree_map(lambda x: x.to(dev), params),
                                    opt, 3, layout)
            for b in batches:
                state, m = rnd(state, {"tokens": b.to(dev)})
            out[dev] = (state["params"].cpu(),
                        {k: v.cpu() for k, v in m.items()
                         if isinstance(v, torch.Tensor)})
        compare(f"round {name} params (cuda vs cpu)", out["cuda"][0],
                out["cpu"][0], rtol=1e-4, atol=atol)
        for k in ("loss", "grad_sq_traj", "consensus_sq", "consensus_sq_post"):
            compare(f"round {name} {k} (cuda vs cpu)", out["cuda"][1][k],
                    out["cpu"][1][k], rtol=1e-4, atol=1e-6)
        log(f"reference check: {name} round on the card agrees with the CPU")


def main_path(torch, K):
    """Phase 5: paper-lenet at full width through the launcher's builder."""
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch.train import build_run

    G, T, per_group, seq = 4, 4, 2, 128
    plan = [("adamw", 1e-3, "final", 3), ("sgd", 0.05, "final", 1),
            ("momentum", 0.05, "final", 1), ("adamw", 1e-3, "traj", 1)]
    mods = {"fused_sgd": K.fused_sgd, "fused_momentum": K.fused_momentum,
            "fused_adamw": K.fused_adamw, "sq_norm_groups": K.sq_norm}

    def counts():
        return {name: mod.launches for name, mod in mods.items()}

    expected = {"fused_sgd": T, "fused_momentum": T,
                "fused_adamw": 3 * T + T,
                "sq_norm_groups": 2 * sum(r for *_, r in plan) + T}
    for mod in mods.values():
        mod.launches = 0
    for opt, lr, metrics, rounds in plan:
        torch.cuda.reset_peak_memory_stats()
        cfg, _, layout, rnd, state = build_run(
            "paper-lenet", groups=G, t_inner=T, opt=opt, lr=lr,
            metrics=metrics, seed=0, device="cuda")
        if layout.size != MAIN[1]:
            fail(f"paper-lenet packs to {layout.size}, expected {MAIN[1]}")
        # the paper's full-batch local GD: each group keeps one fixed shard
        tokens = next(TokenPipeline(cfg.vocab_size, seq, seed=0).batches(
            (G, per_group)))["tokens"]
        batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
        losses = []
        for n in range(rounds):
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = rnd(state, batch)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            # one update launch per local step; the norm twice per round
            # (consensus before and after the exchange), plus once per
            # step with metrics="traj"
            want = dict.fromkeys(mods, 0)
            want[f"fused_{opt}"] = T
            want["sq_norm_groups"] = 2 + (T if metrics == "traj" else 0)
            got = {k: v - before[k] for k, v in counts().items()}
            if got != want:
                fail(f"{opt} round {n}: launches {got}, expected {want}")
            loss = m["loss"]
            if loss.shape != (G,) or not bool(torch.isfinite(loss).all()):
                fail(f"{opt} round {n}: loss {loss.tolist()}")
            if not bool(torch.isfinite(state["params"]).all()):
                fail(f"{opt} round {n}: params are not finite")
            losses.append(loss.mean().item())
            log(f"main path {opt:8s} metrics={metrics} round {n}: "
                f"{sec:.4f} s fenced, loss {losses[-1]:.4f}, gsq "
                f"{m['grad_sq'].mean().item():.4e}, cons "
                f"{m['consensus_sq'].mean().item():.4e}, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if rounds == 3 and not losses[2] < losses[0]:
            fail(f"adamw loss did not fall over 3 rounds: {losses}")
        del state, rnd
        torch.cuda.empty_cache()
    total = counts()
    log(f"main path launches {total} (expected {expected})")
    if total != expected:
        fail(f"launch counts {total} != expected {expected}")
    return total


def profile_round(torch):
    """Phase 6: one more adamw round of the main path under torch.profiler
    (after the launch counts are read): the device's busy share of the
    fenced round and the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch.train import build_run

    cfg, _, _, rnd, state = build_run("paper-lenet", groups=4, t_inner=4,
                                      opt="adamw", lr=1e-3, seed=0,
                                      device="cuda")
    tokens = next(TokenPipeline(cfg.vocab_size, 128, seed=0).batches(
        (4, 2)))["tokens"]
    batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
    state, _ = rnd(state, batch)                 # warm-up round
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = rnd(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        log("profile: the profiler captured no device time")
        return
    log(f"profile: adamw round {wall_ms:.1f} ms fenced (profiler on), "
        f"device busy {busy_ms:.1f} ms = {busy_ms / wall_ms:.1%}, "
        f"{sum(e.count for e in kernels)} kernel launches")
    groups = {"port kernels": ("update_rows", "sq_norm_"),
              "matmul": ("gemm", "sm90", "cutlass", "splitK", "Kernel2"),
              "copy/fill": ("copy", "fill", "Memcpy", "Memset")}
    shares = dict.fromkeys(list(groups) + ["other"], 0.0)
    for e in kernels:
        name = next((g for g, keys in groups.items()
                     if any(k in e.key for k in keys)), "other")
        shares[name] += e.self_device_time_total / 1e3
    log("profile: device ms by kind " + ", ".join(
        f"{k} {v:.1f}" for k, v in shares.items()))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"profile:   {e.self_device_time_total / 1e3:8.2f} ms "
            f"x{e.count:<5d} {e.key[:110]}")
    del state, rnd
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found; run from the root of "
              "a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch import kernels as K
    # the wrapper modules, reached below as attributes of K
    from repro_torch.kernels import (build, fused_adamw,  # noqa: F401
                                     fused_momentum, fused_sgd, ref, sq_norm)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    smi = smi.strip().splitlines()[0]
    log(smi)
    log(f"device {torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
        f"CUDA {torch.version.cuda}; python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    build.load_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for "
        f"{sorted(build.SIGNATURES)}")
    for stem in sorted(build.SIGNATURES):
        for line in build.build_log(stem).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {stem}: {line.strip()}")

    results = check_kernels(torch, K, ref)
    reference_check(torch)
    counts = main_path(torch, K)
    profile_round(torch)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
