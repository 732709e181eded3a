"""Training launcher for the port: the paper's packed local-SGD rounds on
one device (counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-lenet \\
        --packed --opt adamw --rounds 20
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch paper-mlp --reduced --packed --comm ring --codec int8 \\
        --mix-rounds 2

Runs on ``cuda`` unless ``--device cpu`` is given; on ``cuda`` the
updates, norms and exchange codecs launch the CUDA kernels of
``repro_torch/kernels``.
Round times are fenced with ``torch.cuda.synchronize()``. The flags are
the reference launcher's that this slice covers; its other flags are
refused with the ROADMAP.md item that will port them.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import comm as comm_mod
from repro_torch import optim
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs.base import get_config
from repro_torch.core import localsgd as lsgd
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.models.api import build_model
from repro_torch.optim import packing

# the reference launcher's flags outside this slice -> the ROADMAP item
_NOT_PORTED = {
    "--threshold": "core/localsgd.py threshold mode",
    "--adaptive-t": "telemetry (core/controller.py)",
    "--cost-ratio": "telemetry (core/controller.py)",
    "--shard": "sharding/shardexec.py -> torch.distributed",
    "--hop-impl": "sharding/shardexec.py -> torch.distributed",
    "--overlap": "faults, push_sum, tiers and overlap",
    "--drop-rate": "faults, push_sum, tiers and overlap",
    "--stall-rate": "faults, push_sum, tiers and overlap",
    "--fault-seed": "faults, push_sum, tiers and overlap",
    "--n-pods": "faults, push_sum, tiers and overlap",
    "--intra-topology": "faults, push_sum, tiers and overlap",
    "--inter-topology": "faults, push_sum, tiers and overlap",
    "--inter-codec": "faults, push_sum, tiers and overlap",
    "--intra-drop-rate": "faults, push_sum, tiers and overlap",
    "--intra-stall-rate": "faults, push_sum, tiers and overlap",
    "--trace": "telemetry",
    "--profile": "telemetry",
}


def build_run(arch: str, *, reduced: bool = False, groups: int = 4,
              t_inner: int = 4, t_i=None, opt: str = "sgd", lr: float = 0.05,
              impl: str = "auto", comm: str = "server", codec: str = "fp32",
              moment_codec: str = "fp32", downlink_codec: str = "",
              mix_rounds: int = 1, staleness: int = 1,
              metrics: str = "final", seed: int = 0, device="cuda"):
    """Model, packed layout, round and initial state of one run.
    Returns (cfg, model, layout, round_fn, state). The exchange's codecs
    draw from codec seed 0, as the reference launcher's do."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, schedule="rect")
    params = model.init(torch.Generator(device=device).manual_seed(seed),
                        device)
    layout = packing.layout_of(params)
    optimizer = optim.get(opt, lr, packed=True, impl=impl)
    exchange = comm_mod.get_exchange(
        comm, codec, groups, mix_rounds=mix_rounds, staleness=staleness,
        impl=impl, moment_codec=moment_codec, downlink_codec=downlink_codec)
    lcfg = lsgd.LocalSGDConfig(
        n_groups=groups, inner_steps=max(t_i) if t_i else t_inner,
        t_i=tuple(t_i) if t_i else None, metrics=metrics)
    round_fn = lsgd.make_local_round(model.loss, optimizer, lcfg,
                                     layout=layout, exchange=exchange)
    state = lsgd.init_state(params, optimizer, groups, layout,
                            exchange=exchange)
    return cfg, model, layout, round_fn, state


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-lenet")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", default="localsgd", choices=["localsgd", "sync"])
    ap.add_argument("--groups", type=int, default=4)
    ap.add_argument("--per-group", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--t-inner", type=int, default=4)
    ap.add_argument("--t-i", default="",
                    help="comma-separated per-node T_i (paper Alg 1), "
                         "e.g. --t-i 1,4,8,16; the max is the step count")
    ap.add_argument("--opt", default="sgd",
                    choices=["sgd", "momentum", "adamw"])
    ap.add_argument("--packed", action="store_true",
                    help="flat-buffer round: fused whole-model updates on "
                         "one (G, N) f32 buffer (DESIGN.md §6); required")
    ap.add_argument("--impl", default="auto", choices=["auto", "torch", "cuda"],
                    help="update/norm kernels: 'auto' launches the CUDA "
                         "kernels on a CUDA device, 'torch' takes the plain "
                         "versions")
    ap.add_argument("--comm", "--topology", dest="comm", default="server",
                    help="exchange topology: server, ring, gossip, "
                         "async_stale or none (push_sum and hierarchical "
                         "are not ported yet)")
    ap.add_argument("--codec", default="fp32",
                    help="params wire codec: fp32, fp16, bf16, int8, "
                         "int8z or topk")
    ap.add_argument("--moment-codec", default="fp32",
                    help="wire codec of every optimizer moment stream "
                         "(fp32, fp16, bf16, int8, int8z)")
    ap.add_argument("--downlink-codec", default="",
                    help="codec of the server/async_stale broadcast reply "
                         "(fp32, fp16, bf16, int8); default: the idealized "
                         "broadcast priced at the uplink widths")
    ap.add_argument("--mix-rounds", type=int, default=1,
                    help="W hops per round on ring/gossip")
    ap.add_argument("--staleness", type=int, default=1,
                    help="staleness bound s of async_stale")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    ap.add_argument("--checkpoint", default="",
                    help="save the averaged server params here (npz + json, "
                         "no extension) for repro_torch.launch.serve "
                         "--from-checkpoint")
    args, unknown = ap.parse_known_args(argv)
    for tok in unknown:
        flag = tok.split("=")[0]
        if flag in _NOT_PORTED:
            ap.error(f"{flag} is not ported yet (ROADMAP.md Queue A, "
                     f"{_NOT_PORTED[flag]})")
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    if args.mode == "sync":
        ap.error("--mode sync (make_sync_step) is not ported yet (ROADMAP.md "
                 "Queue A, core/localsgd.py)")
    if not args.packed:
        ap.error("the port runs the packed round only: add --packed (the "
                 "pytree round is ROADMAP.md Queue A, core/localsgd.py)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda, but CUDA is not available here: run on a "
                 "machine with an NVIDIA GPU, or pass --device cpu")
    t_i = [int(v) for v in args.t_i.split(",")] if args.t_i else None
    if t_i and len(t_i) != args.groups:
        ap.error(f"--t-i needs {args.groups} entries, got {len(t_i)}")
    try:
        cfg, _, layout, rnd, state = build_run(
            args.arch, reduced=args.reduced, groups=args.groups,
            t_inner=args.t_inner, t_i=t_i, opt=args.opt, lr=args.lr,
            impl=args.impl, comm=args.comm, codec=args.codec,
            moment_codec=args.moment_codec,
            downlink_codec=args.downlink_codec, mix_rounds=args.mix_rounds,
            staleness=args.staleness, seed=args.seed, device=device)
    except NotImplementedError as e:
        ap.error(str(e))
    print(f"arch={cfg.name} params={layout.size / 1e6:.1f}M mode=localsgd "
          f"device={device}")

    def fence():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    pipe = TokenPipeline(cfg.vocab_size, args.seq, seed=args.seed)
    batches = pipe.batches((args.groups, args.per_group))
    wire_total = 0
    for n in range(args.rounds):
        batch = {"tokens": torch.as_tensor(next(batches)["tokens"],
                                           device=device)}
        fence()
        t0 = time.perf_counter()
        state, m = rnd(state, batch)
        fence()
        seconds = time.perf_counter() - t0
        wire_total += int(m["wire_bytes"])
        if n % args.log_every == 0:
            print(f"round {n:4d} "
                  f"loss {float(m['loss'].mean()):.4f} "
                  f"gsq {float(m['grad_sq'].mean()):.3e} "
                  f"T {int(m['inner_steps'].max())} "
                  f"wire {int(m['wire_bytes']):,}B "
                  f"part {float(m['participation']):.2f} "
                  f"cons {float(m['consensus_sq'].mean()):.3e} "
                  f"({seconds:.2f}s)")
    print(f"comm {args.comm}/{args.codec}: {wire_total:,} wire bytes over "
          f"{args.rounds} rounds")
    if args.checkpoint:
        ckpt_io.save(args.checkpoint, lsgd.server_params(state, layout),
                     metadata={"arch": cfg.name, "rounds": args.rounds,
                               "mode": args.mode})
        print(f"checkpoint -> {args.checkpoint}.npz")


if __name__ == "__main__":
    main()
