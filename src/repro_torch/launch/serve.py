"""Serving launcher for the port: the continuous-batching engine
(``repro_torch.serve``) over a Poisson request workload, with
checkpoint -> serve handoff (counterpart of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-lenet \\
        --from-checkpoint experiments/ckpt/lenet --slots 8 --page-size 16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch paper-mlp --reduced --check-parity

Runs on ``cuda`` unless ``--device cpu`` is given; on ``cuda`` decode
attention (and, with ``attn_impl="pallas"`` configs, the prefill's
flash attention) launch the CUDA kernels of ``repro_torch/kernels``.
``--from-checkpoint`` takes a file saved by either package's
``launch/train.py --checkpoint`` (pytree or packed). Timings are fenced
(``obs.Trace``); ``--trace`` writes the per-step JSONL that ``python -m
repro.obs.report <file> --check`` validates. ``--check-parity`` replays
every request alone through an engine with the same slot count (so every
product has the same shapes) and fails on any token that differs.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.models.api import build_model
from repro_torch.obs.trace import Trace
from repro_torch.serve import (Engine, EngineConfig, Request, drive_workload,
                               poisson_workload, restore_params)


def build_engine(model, params, args, policy: str, trace=None) -> Engine:
    return Engine(model, params, EngineConfig(
        n_slots=args.slots, page_size=args.page_size,
        max_prompt=args.prompt_max, max_new=args.gen_max,
        impl=args.impl, policy=policy), trace=trace)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-lenet")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--engine", default="continuous",
                    choices=("continuous", "static"))
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=4.0,
                    help="Poisson arrival rate (req/s, virtual clock)")
    ap.add_argument("--prompt-min", type=int, default=4)
    ap.add_argument("--prompt-max", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8,
                    help="min generated tokens per request")
    ap.add_argument("--gen-max", type=int, default=16)
    ap.add_argument("--impl", default="auto",
                    choices=("auto", "torch", "cuda"),
                    help="attention kernels: 'auto' launches the CUDA "
                         "kernels on a CUDA device, 'torch' takes the plain "
                         "versions")
    ap.add_argument("--from-checkpoint", default="",
                    help="restore params saved by launch/train.py "
                         "--checkpoint (pytree or packed, either package)")
    ap.add_argument("--trace", default="", help="JSONL trace sink")
    ap.add_argument("--check-parity", action="store_true",
                    help="replay each request alone; fail on any token "
                         "that differs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda, but CUDA is not available here: run on a "
                 "machine with an NVIDIA GPU, or pass --device cpu")
    try:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        model = build_model(cfg)
        if args.from_checkpoint:
            params = restore_params(args.from_checkpoint, model,
                                    device=device)
            print(f"params <- {args.from_checkpoint}.npz")
        else:
            params = model.init(torch.Generator(device=device).manual_seed(
                args.seed), device)
    except NotImplementedError as e:
        ap.error(str(e))

    trace = Trace(args.trace or None,
                  meta={"launcher": "serve", "arch": cfg.name,
                        "engine": args.engine, "slots": args.slots,
                        "page_size": args.page_size, "device": str(device)})
    engine = build_engine(model, params, args, args.engine, trace)
    engine.warmup()

    gen = (min(args.gen, args.gen_max), args.gen_max)
    reqs = poisson_workload(args.rate, args.requests, seed=args.seed,
                            prompt_len=(args.prompt_min, args.prompt_max),
                            max_new=gen, vocab=cfg.vocab_size)
    done, makespan = drive_workload(
        engine, [Request(r.rid, r.prompt.copy(), r.max_new, r.arrival)
                 for r in reqs])
    trace.close()

    lat = np.sort([c.latency for c in done])
    committed = sum(len(c.tokens) for c in done)
    print(f"arch={cfg.name} engine={args.engine} slots={args.slots} "
          f"page={args.page_size} impl={args.impl} device={device}")
    print(f"{len(done)} requests, {committed} tokens committed in "
          f"{makespan:.2f}s virtual ({committed / max(makespan, 1e-9):.1f}"
          " tok/s)")
    print(f"latency p50 {np.percentile(lat, 50):.3f}s "
          f"p99 {np.percentile(lat, 99):.3f}s")
    if args.trace:
        print(f"trace -> {args.trace} ({trace.n_records} records)")

    if args.check_parity:
        # alone, at the same slot count: the batch shapes equal the run's,
        # so no product may round differently for another shape
        iso = build_engine(model, params, args, "continuous")
        got = {c.rid: c.tokens for c in done}
        bad = 0
        for r in reqs:
            ref = iso.run([Request(r.rid, r.prompt.copy(), r.max_new)])
            if got[r.rid] != ref[0].tokens:
                bad += 1
                print(f"PARITY FAIL rid={r.rid}: engine {got[r.rid]} "
                      f"!= isolated {ref[0].tokens}")
        if bad:
            raise SystemExit(f"parity check failed for {bad} request(s)")
        print(f"parity OK: {len(reqs)} requests identical to isolated "
              "decode")


if __name__ == "__main__":
    main()
