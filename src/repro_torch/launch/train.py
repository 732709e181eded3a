"""Training launcher for the port: the paper's local-SGD rounds (or the
sync-DP baseline) on one device (counterpart of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-lenet \\
        --packed --opt adamw --rounds 20
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch paper-mlp --reduced --packed --comm ring --codec int8 \\
        --mix-rounds 2
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch paper-mlp --reduced --threshold 1e-1     # T_i = inf
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch paper-mlp --reduced --packed --mode sync

Runs on ``cuda`` unless ``--device cpu`` is given; on ``cuda`` the
packed updates, norms and exchange codecs launch the CUDA kernels of
``repro_torch/kernels`` (the pytree round, without ``--packed``, has
none). ``--adaptive-t`` refits T every round from the round's local
gradient-norm trajectory (paper Sec 4, ``core/controller.py``
``AdaptiveT``). Round times are fenced with ``torch.cuda.synchronize()``.
The flags are the reference launcher's that the port covers; its other
flags are refused with the ROADMAP.md item that will port them.
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch import comm as comm_mod
from repro_torch import optim, tree
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs.base import get_config
from repro_torch.core import localsgd as lsgd
from repro_torch.core.controller import AdaptiveT
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.models.api import build_model
from repro_torch.optim import packing

# the reference launcher's flags outside this slice -> the ROADMAP item
_NOT_PORTED = {
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


# the threshold mode's cap on local steps a round (the reference
# launcher's)
MAX_INNER = 500


def build_run(arch: str, *, reduced: bool = False, groups: int = 4,
              t_inner: int = 4, t_i=None, threshold=None,
              packed: bool = True, opt: str = "sgd", lr: float = 0.05,
              impl: str = "auto", comm: str = "server", codec: str = "fp32",
              moment_codec: str = "fp32", downlink_codec: str = "",
              mix_rounds: int = 1, staleness: int = 1,
              metrics: str = "final", seed: int = 0, device="cuda"):
    """Model, layout (None for the pytree round), round, initial state,
    round config and a ``rebuild(lcfg)`` for another config of the same
    run. Returns (cfg, model, layout, round_fn, state, lcfg, rebuild).
    The exchange's codecs draw from codec seed 0, as the reference
    launcher's do."""
    cfg, model, params, layout, optimizer = _model_and_opt(
        arch, reduced, packed, opt, lr, impl, seed, device)
    exchange = comm_mod.get_exchange(
        comm, codec, groups, mix_rounds=mix_rounds, staleness=staleness,
        impl=impl, moment_codec=moment_codec, downlink_codec=downlink_codec)
    lcfg = lsgd.LocalSGDConfig(
        n_groups=groups, inner_steps=max(t_i) if t_i else t_inner,
        t_i=tuple(t_i) if t_i else None, threshold=threshold,
        max_inner=MAX_INNER, metrics=metrics)

    def rebuild(lc):
        return lsgd.make_local_round(model.loss, optimizer, lc,
                                     layout=layout, exchange=exchange)

    state = lsgd.init_state(params, optimizer, groups, layout,
                            exchange=exchange)
    return cfg, model, layout, rebuild(lcfg), state, lcfg, rebuild


def build_sync(arch: str, *, reduced: bool = False, packed: bool = True,
               opt: str = "sgd", lr: float = 0.05, impl: str = "auto",
               seed: int = 0, device="cuda"):
    """The sync-DP baseline of one run: (cfg, model, layout, step, state)."""
    cfg, model, params, layout, optimizer = _model_and_opt(
        arch, reduced, packed, opt, lr, impl, seed, device)
    step = lsgd.make_sync_step(model.loss, optimizer, layout=layout)
    return cfg, model, layout, step, lsgd.init_state(params, optimizer,
                                                     layout=layout)


def _model_and_opt(arch, reduced, packed, opt, lr, impl, seed, device):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, schedule="rect")
    params = model.init(torch.Generator(device=device).manual_seed(seed),
                        device)
    layout = packing.layout_of(params) if packed else None
    optimizer = optim.get(opt, lr, packed=packed,
                          **({"impl": impl} if packed else {}))
    return cfg, model, params, layout, optimizer


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
    ap.add_argument("--threshold", type=float, default=None,
                    help="T_i=inf mode: local steps until ||g||^2<=eps "
                         "(the pytree round; at most 500 a round)")
    ap.add_argument("--adaptive-t", nargs="?", const="static", default="",
                    choices=["static", "online"],
                    help="T controller: 'static' (bare --adaptive-t: the "
                         "Sec-4 fit from the round's decay trajectory); "
                         "'online' is not ported yet")
    ap.add_argument("--cost-ratio", type=float, default=0.01,
                    help="r = C_g/C_c for the adaptive controller")
    ap.add_argument("--opt", default="sgd",
                    choices=["sgd", "momentum", "adamw"])
    ap.add_argument("--packed", action="store_true",
                    help="flat-buffer round: fused whole-model updates on "
                         "one (G, N) f32 buffer (DESIGN.md §6); without it, "
                         "the pytree round")
    ap.add_argument("--impl", default="auto", choices=["auto", "torch", "cuda"],
                    help="packed update/norm kernels: 'auto' launches the "
                         "CUDA kernels on a CUDA device, 'torch' takes the "
                         "plain versions")
    ap.add_argument("--comm", "--topology", dest="comm", default="server",
                    help="exchange topology: server, ring, gossip, "
                         "async_stale or none (push_sum and hierarchical "
                         "are not ported yet)")
    ap.add_argument("--codec", default="fp32",
                    help="params wire codec: fp32, fp16, bf16, int8, "
                         "int8z or topk (lossy codecs need --packed)")
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
    if args.adaptive_t == "online":
        ap.error("--adaptive-t online is not ported yet (ROADMAP.md Queue A, "
                 "telemetry: OnlineT needs the fenced exchange phases)")
    if args.mode == "sync" and (args.comm != "server" or args.codec != "fp32"
                                or args.moment_codec != "fp32"
                                or args.downlink_codec):
        ap.error("--comm/--codec select the local-SGD model exchange; "
                 "sync-DP all-reduces gradients every step and has no "
                 "exchange to configure")
    if args.impl != "auto" and not args.packed:
        ap.error("--impl selects the packed fused kernels; add --packed")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda, but CUDA is not available here: run on a "
                 "machine with an NVIDIA GPU, or pass --device cpu")
    t_i = [int(v) for v in args.t_i.split(",")] if args.t_i else None
    if t_i and len(t_i) != args.groups:
        ap.error(f"--t-i needs {args.groups} entries, got {len(t_i)}")

    def fence():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    common = dict(reduced=args.reduced, packed=args.packed, opt=args.opt,
                  lr=args.lr, impl=args.impl, seed=args.seed, device=device)
    if args.mode == "sync":
        cfg, model, layout, step, state = build_sync(args.arch, **common)
        _header(cfg, model, args, device)
        pipe = TokenPipeline(cfg.vocab_size, args.seq, seed=args.seed)
        batches = pipe.batches((args.groups * args.per_group,))
        for n in range(args.rounds):
            batch = {"tokens": torch.as_tensor(next(batches)["tokens"],
                                               device=device)}
            fence()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            fence()
            if n % args.log_every == 0:
                print(f"step {n:4d} loss {float(m['loss']):.4f} "
                      f"gsq {float(m['grad_sq']):.3e} "
                      f"({time.perf_counter() - t0:.2f}s)")
        final = (packing.unpack(state["params"], layout) if args.packed
                 else state["params"])
    else:
        try:
            cfg, model, layout, rnd, state, lcfg, rebuild = build_run(
                args.arch, groups=args.groups, t_inner=args.t_inner, t_i=t_i,
                threshold=args.threshold, comm=args.comm, codec=args.codec,
                moment_codec=args.moment_codec,
                downlink_codec=args.downlink_codec,
                mix_rounds=args.mix_rounds, staleness=args.staleness,
                metrics="traj" if args.adaptive_t else "final", **common)
        except NotImplementedError as e:
            ap.error(str(e))
        _header(cfg, model, args, device)
        # the reliable network: the cost ratio is not repriced by delivery
        ctl = AdaptiveT(r=args.cost_ratio) if args.adaptive_t else None
        t_cur = lcfg.inner_steps
        pipe = TokenPipeline(cfg.vocab_size, args.seq, seed=args.seed)
        batches = pipe.batches((args.groups, args.per_group))
        wire_total = 0
        for n in range(args.rounds):
            batch = {"tokens": torch.as_tensor(next(batches)["tokens"],
                                               device=device)}
            if ctl is not None and t_cur != lcfg.inner_steps:
                # a new T: the controller's T for every group, no t_i and
                # no threshold (as the reference launcher rebuilds it)
                lcfg = lsgd.LocalSGDConfig(
                    n_groups=args.groups, inner_steps=t_cur,
                    max_inner=MAX_INNER, metrics=lcfg.metrics)
                rnd = rebuild(lcfg)
            fence()
            t0 = time.perf_counter()
            state, m = rnd(state, batch)
            fence()
            seconds = time.perf_counter() - t0
            if ctl is not None and "grad_sq_traj" in m:
                t_cur = ctl.update(m["grad_sq_traj"][0].cpu().numpy())
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
        final = lsgd.server_params(state, layout)
    if args.checkpoint:
        ckpt_io.save(args.checkpoint, final,
                     metadata={"arch": cfg.name, "rounds": args.rounds,
                               "mode": args.mode})
        print(f"checkpoint -> {args.checkpoint}.npz")


def _header(cfg, model, args, device) -> None:
    n = sum(math.prod(d.shape) for d in tree.leaves(model.defs))
    print(f"arch={cfg.name} params={n / 1e6:.1f}M mode={args.mode} "
          f"{'packed' if args.packed else 'pytree'} device={device}")


if __name__ == "__main__":
    main()
