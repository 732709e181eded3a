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
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch paper-mlp --reduced --packed --comm push_sum \\
        --drop-rate 0.05                          # an unreliable network
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch paper-mlp --reduced --packed --comm hierarchical \\
        --groups 8 --n-pods 4 --drop-rate 0.075   # two tiers, lossy DCN
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch paper-mlp --reduced --packed --comm ring --codec int8 \\
        --overlap                                 # delayed mixing
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch paper-mlp --reduced --comm push_sum \\
        --drop-rate 0.1                           # on the pytree round

Runs on ``cuda`` unless ``--device cpu`` is given; on ``cuda`` the
packed updates, norms and exchange codecs launch the CUDA kernels of
``repro_torch/kernels``. The pytree round, without ``--packed``, has
none: it takes every exchange flag the reference's pytree round takes
(the cast codecs, async_stale, the fault flags, push_sum and the tiers),
each stream mixed leaf by leaf; int8, int8z, top-k and ``--overlap``
need ``--packed``, as in the reference. ``--adaptive-t`` refits T every round from the round's local
gradient-norm trajectory (paper Sec 4, ``core/controller.py``
``AdaptiveT``; on a lossy network the cost ratio is repriced by the
exchange's delivery rate). Each round prints its participation (the
delivered fraction of its transmissions). Round times are fenced with
``torch.cuda.synchronize()``.
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
              drop_rate: float = 0.0, stall_rate: float = 0.0,
              fault_seed: int = 0, overlap: bool = False, n_pods: int = 0,
              intra_topology: str = "ring", inter_topology: str = "push_sum",
              inter_codec: str = "", intra_drop_rate: float = 0.0,
              intra_stall_rate: float = 0.0, metrics: str = "final",
              seed: int = 0, device="cuda"):
    """Model, layout (None for the pytree round), round, initial state,
    round config, a ``rebuild(lcfg)`` for another config of the same run,
    and the exchange. Returns (cfg, model, layout, round_fn, state, lcfg,
    rebuild, exchange). The exchange's codecs draw from codec seed 0, as
    the reference launcher's do; its fault plan from ``fault_seed``."""
    cfg, model, params, layout, optimizer = _model_and_opt(
        arch, reduced, packed, opt, lr, impl, seed, device)
    exchange = comm_mod.get_exchange(
        comm, codec, groups, mix_rounds=mix_rounds, staleness=staleness,
        impl=impl, moment_codec=moment_codec, downlink_codec=downlink_codec,
        drop_rate=drop_rate, stall_rate=stall_rate, fault_seed=fault_seed,
        overlap=overlap, n_pods=n_pods, intra_topology=intra_topology,
        inter_topology=inter_topology, inter_codec=inter_codec,
        intra_drop_rate=intra_drop_rate, intra_stall_rate=intra_stall_rate)
    lcfg = lsgd.LocalSGDConfig(
        n_groups=groups, inner_steps=max(t_i) if t_i else t_inner,
        t_i=tuple(t_i) if t_i else None, threshold=threshold,
        max_inner=MAX_INNER, metrics=metrics)

    def rebuild(lc):
        return lsgd.make_local_round(model.loss, optimizer, lc,
                                     layout=layout, exchange=exchange)

    rnd = rebuild(lcfg)         # refuses what the round cannot run
    state = lsgd.init_state(params, optimizer, groups, layout,
                            exchange=exchange)
    return cfg, model, layout, rnd, state, lcfg, rebuild, exchange


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
                         "async_stale, push_sum (loss-tolerant ratio "
                         "consensus), hierarchical (pods, then across "
                         "them) or none")
    ap.add_argument("--n-pods", type=int, default=0,
                    help="hierarchical only: pod count P; must divide "
                         "--groups (pods of G/P groups)")
    ap.add_argument("--intra-topology", default="ring",
                    choices=["ring", "server"],
                    help="hierarchical: the within-pod stage")
    ap.add_argument("--inter-topology", default="push_sum",
                    choices=["push_sum", "server"],
                    help="hierarchical: the cross-pod stage, push_sum over "
                         "the lossy tier or the reliable leader mean")
    ap.add_argument("--inter-codec", default="",
                    choices=["", "fp32", "fp16", "bf16", "int8", "int8z"],
                    help="hierarchical: the cross-pod tier's codec "
                         "(default: each stream's own); int8/int8z need "
                         "--inter-topology server")
    ap.add_argument("--intra-drop-rate", type=float, default=0.0,
                    help="hierarchical: per-edge drop probability within "
                         "pods (its own seed lane; --drop-rate arms the "
                         "cross-pod tier)")
    ap.add_argument("--intra-stall-rate", type=float, default=0.0,
                    help="hierarchical: per-round stall probability "
                         "within pods")
    ap.add_argument("--codec", default="fp32",
                    help="params wire codec: fp32, fp16, bf16, int8, "
                         "int8z or topk (int8, int8z and topk need "
                         "--packed)")
    ap.add_argument("--moment-codec", default="fp32",
                    help="wire codec of every optimizer moment stream "
                         "(fp32, fp16, bf16, int8, int8z; int8 and int8z "
                         "need --packed)")
    ap.add_argument("--downlink-codec", default="",
                    help="codec of the server/async_stale broadcast reply "
                         "(fp32, fp16, bf16, int8; int8 needs --packed); "
                         "default: the idealized broadcast priced at the "
                         "uplink widths")
    ap.add_argument("--mix-rounds", type=int, default=1,
                    help="W hops per round on ring/gossip")
    ap.add_argument("--staleness", type=int, default=1,
                    help="staleness bound s of async_stale")
    ap.add_argument("--overlap", action="store_true",
                    help="delayed mixing: each round mixes the previous "
                         "round's payload (needs --packed and server, ring "
                         "or gossip)")
    ap.add_argument("--drop-rate", type=float, default=0.0,
                    help="fault injection: per-edge packet-drop "
                         "probability in [0, 1); 0 keeps the fault-free "
                         "exchange")
    ap.add_argument("--stall-rate", type=float, default=0.0,
                    help="per-round node stall probability in [0, 1)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the fault masks (pure in (round, seed): "
                         "reruns and resumes replay the same faults)")
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
                                or args.downlink_codec or args.overlap
                                or args.drop_rate or args.stall_rate
                                or args.n_pods or args.inter_codec
                                or args.intra_drop_rate
                                or args.intra_stall_rate):
        ap.error("--comm/--codec/--drop-rate select the local-SGD model "
                 "exchange; sync-DP all-reduces gradients every step and "
                 "has no exchange to configure")
    if args.impl != "auto" and not args.packed:
        ap.error("--impl selects the packed fused kernels; add --packed")
    if args.overlap and not args.packed:
        ap.error("--overlap double-buffers the packed flat stream payload "
                 "(comm['inflight'], DESIGN.md §14); add --packed")
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
            cfg, model, layout, rnd, state, lcfg, rebuild, exchange = \
                build_run(
                    args.arch, groups=args.groups, t_inner=args.t_inner,
                    t_i=t_i, threshold=args.threshold, comm=args.comm,
                    codec=args.codec, moment_codec=args.moment_codec,
                    downlink_codec=args.downlink_codec,
                    mix_rounds=args.mix_rounds, staleness=args.staleness,
                    drop_rate=args.drop_rate, stall_rate=args.stall_rate,
                    fault_seed=args.fault_seed, overlap=args.overlap,
                    n_pods=args.n_pods, intra_topology=args.intra_topology,
                    inter_topology=args.inter_topology,
                    inter_codec=args.inter_codec,
                    intra_drop_rate=args.intra_drop_rate,
                    intra_stall_rate=args.intra_stall_rate,
                    metrics="traj" if args.adaptive_t else "final", **common)
        except (NotImplementedError, ValueError) as e:
            ap.error(str(e))
        _header(cfg, model, args, device)
        # on a lossy network a useful round costs 1/delivery attempts'
        # worth of link time: r shrinks and the controller's T grows
        ctl = (AdaptiveT(r=args.cost_ratio * exchange.delivery_rate)
               if args.adaptive_t else None)
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
        print(f"comm {exchange.name}: {wire_total:,} wire bytes over "
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
