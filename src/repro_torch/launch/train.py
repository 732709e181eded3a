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
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch paper-mlp --reduced --packed --adaptive-t online \\
        --trace t.jsonl --profile prof            # telemetry
    PYTHONPATH=src python -m repro_torch.obs.report t.jsonl --check
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch whisper-base --reduced --packed    # frames beside the tokens
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch paper-mlp --reduced --packed --shard 2 --comm ring \\
        --codec int8                              # G * S ranks
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch paper-mlp --reduced --packed --shard 2 --comm hierarchical \\
        --n-pods 2                                # the tiers, sharded

Runs on ``cuda`` unless ``--device cpu`` is given; on ``cuda`` the
packed updates, norms and exchange codecs launch the CUDA kernels of
``repro_torch/kernels``. The pytree round, without ``--packed``, has
none: it takes every exchange flag the reference's pytree round takes
(the cast codecs, async_stale, the fault flags, push_sum and the tiers),
each stream mixed leaf by leaf; int8, int8z, top-k and ``--overlap``
need ``--packed``, as in the reference. ``--adaptive-t`` refits T every
round from the round's local gradient-norm trajectory (paper Sec 4,
``core/controller.py`` ``AdaptiveT``; on a lossy network the cost ratio
is repriced by the exchange's delivery rate); ``--adaptive-t online``
(``OnlineT``) also re-estimates the cost ratio from the fenced phase
times and scales T by the measured consensus contraction. Either
controller's T stays within ``--t-max`` (the controllers' own cap of
10,000 by default): a round whose gradient norm ends above where it
began fits no decay, and the controller then asks for its cap. Each round
prints its participation (the delivered fraction of its
transmissions). The vlm and audio architectures (``internvl2-1b``,
``whisper-base``) get their stubbed frontends' inputs beside each
batch's tokens (``add_modalities``: patch or frame embeddings from a
numpy ``RandomState(seed)``, the reference launcher's draws bit for
bit).

Every phase is fenced (``obs.Trace``: the devices of what it produced
are synchronized before the clock is read), whether or not ``--trace``
writes the JSONL records. On the packed round, ``--trace``,
``--overlap`` and ``--adaptive-t online`` first calibrate the
exchange-time split (``calibrate_fences``), so each round also records
``exchange_exposed`` and ``exchange_total``. ``--profile <dir>`` writes
a Chrome trace of the rounds (or steps) under ``<dir>``.

``--shard S`` (with ``--packed`` and ``--mode localsgd``) runs the packed
round sharded over G * S ranks (``sharding/shardexec.py``; ``--hop-impl``
picks the ring/gossip hop collective). The launcher builds the kernel
libraries, then starts the ranks on this host and joins them within
``--world-timeout`` seconds, or joins the world that ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` describe (one process a rank, as ``torchrun`` starts
them). Each rank holds its (1, Np / S) block; the metrics are the
unsharded round's (G,) vectors; rank 0 prints, writes the trace and the
profile, and saves the checkpoint, gathered to the unsharded layout. The
transport is printed (``launch/mesh.py``): NCCL where each rank of a
host has a card of its own, else CUDA IPC mailboxes on the shared card.
Every exchange flag of the packed round runs sharded but
``--downlink-codec``, as in the reference: ``--comm hierarchical`` with
its tier flags and ``--overlap`` (whose fence calibration runs on the
ranks' blocks) included.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import math
import os
import sys

import numpy as np
import torch

from repro_torch import comm as comm_mod
from repro_torch import obs, optim, tree
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs.base import get_config
from repro_torch.core import localsgd as lsgd
from repro_torch.core.controller import AdaptiveT, OnlineT
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.api import build_model
from repro_torch.optim import packing
from repro_torch.sharding import shardexec as shx

# the threshold mode's cap on local steps a round (the reference
# launcher's)
MAX_INNER = 500


def add_modalities(batch, cfg, rng):
    """The reference launcher's stub frontend inputs: vlm patch or audio
    frame embeddings (..., n_patches | n_frames, d_model) float32 from
    ``rng`` (a numpy RandomState), on the tokens' device."""
    lead = tuple(batch["tokens"].shape[:-1])
    for family, key, n in (("vlm", "patches", cfg.n_patches),
                           ("audio", "frames", cfg.n_frames)):
        if cfg.family == family:
            batch[key] = torch.as_tensor(
                rng.randn(*lead, n, cfg.d_model).astype(np.float32),
                device=batch["tokens"].device)
    return batch


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
              seed: int = 0, device="cuda", shardexec=None):
    """Model, layout (None for the pytree round), round, initial state,
    round config, a ``rebuild(lcfg)`` for another config of the same run,
    and the exchange. Returns (cfg, model, layout, round_fn, state, lcfg,
    rebuild, exchange). The exchange's codecs draw from codec seed 0, as
    the reference launcher's do; its fault plan from ``fault_seed``. With
    ``shardexec`` the layout is sharded and the state this rank's block."""
    cfg, model, params, layout, optimizer = _model_and_opt(
        arch, reduced, packed, opt, lr, impl, seed, device)
    if shardexec is not None:
        layout = packing.shard_layout(layout, shardexec.n_shards)
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
                                     layout=layout, exchange=exchange,
                                     shardexec=shardexec)

    rnd = rebuild(lcfg)         # refuses what the round cannot run
    state = lsgd.init_state(params, optimizer, groups, layout,
                            exchange=exchange, shardexec=shardexec)
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


def calibrate_fences(loss_fn, opt, lcfg, layout, exchange, params, batch,
                     shardexec=None):
    """The two references ``obs.exchange_phases`` derives the honest
    exchange-time split from (DESIGN.md §14): the SAME packed round built
    with comm='none' gives the pure-local-compute time, and (in overlap
    mode) the barrier variant of the same exchange gives the standalone
    exchange cost. Each round runs from its own fresh ``init_state`` of
    ``params`` (the live run's buffers, noise counters and fault rounds
    are never touched): one warm-up (the kernel library's load and the
    first use of the device), then the best of two fenced rounds.
    Returns ``(local_ref_per_step_s, exch_ref_s)``; the local reference
    scales linearly in T, so one calibration covers the whole run."""
    n_groups = lcfg.n_groups

    def best_round_s(exch):
        rnd = lsgd.make_local_round(loss_fn, opt, lcfg, layout=layout,
                                    exchange=exch, shardexec=shardexec)
        st = lsgd.init_state(params, opt, n_groups, layout, exchange=exch,
                             shardexec=shardexec)
        best = float("inf")
        for i in range(3):
            with obs.PhaseTimer() as t:
                st, _ = t(rnd(st, batch))
            if i:
                best = min(best, t.seconds)
        return best

    local_ref_s = best_round_s(comm_mod.get_exchange("none", "fp32",
                                                     n_groups))
    exch_ref_s = 0.0
    if exchange.overlap:
        barrier = dataclasses.replace(exchange, overlap=False)
        exch_ref_s = max(0.0, best_round_s(barrier) - local_ref_s)
    gc.collect()
    if batch["tokens"].is_cuda:
        torch.cuda.empty_cache()
    return local_ref_s / max(lcfg.inner_steps, 1), exch_ref_s


def _parser() -> argparse.ArgumentParser:
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
                         "Sec-4 fit from the round's decay trajectory) or "
                         "'online' (DESIGN.md §14: re-estimates the cost "
                         "ratio from fenced phase times and scales T by "
                         "the measured consensus contraction each round)")
    ap.add_argument("--cost-ratio", type=float, default=0.01,
                    help="r = C_g/C_c for the adaptive controller (online "
                         "mode uses it as the prior and refines it from "
                         "measured phase times)")
    ap.add_argument("--t-max", type=int, default=OnlineT.t_max,
                    help="cap on the adaptive controller's T (a round "
                         "that fits no decay asks for the cap)")
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
    ap.add_argument("--shard", type=int, default=1,
                    help="in-group shard count S (packed localsgd only): "
                         "shards the flat buffer over G * S ranks, rank "
                         "g * S + s holding shard s of group g, the fused, "
                         "norm and codec kernels on the local shard "
                         "(DESIGN.md §9)")
    ap.add_argument("--world-timeout", type=float, default=6 * 3600.0,
                    help="--shard: seconds the started ranks have to "
                         "finish, after which they are stopped and the "
                         "run fails (a rank that fails stops them at "
                         "once; a collective waiting past 120 s raises)")
    ap.add_argument("--hop-impl", default="ppermute",
                    choices=["ppermute", "allgather"],
                    help="sharded ring/gossip hop collective (DESIGN.md "
                         "§11): point-to-point neighbour exchange "
                         "(O(deg*shard) wire) or the dense all_gather")
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
    ap.add_argument("--trace", default="",
                    help="write phase-fenced JSONL round records here "
                         "(DESIGN.md §13); summarize or check them with "
                         "PYTHONPATH=src python -m repro_torch.obs.report")
    ap.add_argument("--profile", default="",
                    help="write a Chrome trace (torch.profiler; CPU and, on "
                         "a CUDA device, CUDA activity) of the rounds under "
                         "this directory")
    return ap


def main(argv=None) -> None:
    ap = _parser()
    argv = list(argv) if argv is not None else None
    args = ap.parse_args(argv)
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
    if args.shard > 1 and not (args.packed and args.mode == "localsgd"):
        ap.error("--shard shards the packed flat buffer over a mesh; it "
                 "needs --packed and --mode localsgd")
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
    if args.shard > 1:
        _check_sharded(ap, args, t_i)
        world = args.groups * args.shard
        if "WORLD_SIZE" in os.environ:
            # one process a rank, started by the caller (torchrun)
            if int(os.environ["WORLD_SIZE"]) != world:
                ap.error(f"WORLD_SIZE={os.environ['WORLD_SIZE']}, but "
                         f"--groups {args.groups} x --shard {args.shard} "
                         f"is {world} ranks")
            rank, _, local_rank, local_world = mesh_mod.env_ranks()
            ok = False
            try:
                _train(args, t_i, mesh_mod.init_world(
                    rank, world, device_type=device.type,
                    local_rank=local_rank, local_world=local_world),
                    sharded=True)
                ok = True
            finally:
                mesh_mod.leave_world(close=ok)
            return
        if device.type == "cuda":
            # every library built before the ranks start: none of them
            # compiles, or loads a half-written one
            from repro_torch.kernels import build
            build.load_all()
        mesh_mod.run_ranks(_rank_main, world,
                           argv if argv is not None else sys.argv[1:],
                           device_type=device.type,
                           timeout=args.world_timeout)
        return
    _train(args, t_i, device, sharded=False, ap=ap)


def _check_sharded(ap, args, t_i) -> None:
    """The sharded run's refusals, on shapes alone, before any rank
    starts: the reference launcher's guards and the sharded exchange's."""
    try:
        exchange = comm_mod.get_exchange(
            args.comm, args.codec, args.groups, mix_rounds=args.mix_rounds,
            staleness=args.staleness, moment_codec=args.moment_codec,
            downlink_codec=args.downlink_codec, drop_rate=args.drop_rate,
            stall_rate=args.stall_rate, fault_seed=args.fault_seed,
            overlap=args.overlap, n_pods=args.n_pods,
            intra_topology=args.intra_topology,
            inter_topology=args.inter_topology, inter_codec=args.inter_codec,
            intra_drop_rate=args.intra_drop_rate,
            intra_stall_rate=args.intra_stall_rate)
        shx.check_exchange(exchange)
    except (NotImplementedError, ValueError) as e:
        ap.error(str(e))
    if args.threshold is not None:
        ap.error("threshold (T_i=inf) mode runs on the pytree path; "
                 "--shard needs --packed")
    if t_i and optim.get(args.opt, args.lr, packed=True).count_dependent:
        ap.error("per-node --t-i with a count-dependent update (adamw) "
                 "keeps a (G,) count vector outside the sharded opt step; "
                 "run it without --shard (DESIGN.md §10)")


def _rank_main(rank: int, world: int, argv) -> None:
    """One rank of a sharded run started by ``main``."""
    args = _parser().parse_args(argv)
    t_i = [int(v) for v in args.t_i.split(",")] if args.t_i else None
    _train(args, t_i, mesh_mod.rank_device(rank, args.device.split(":")[0]),
           sharded=True)


def _train(args, t_i, device, *, sharded: bool, ap=None) -> None:
    """The run itself: one process, or one rank of a sharded world (rank
    0 prints, traces, profiles and saves)."""
    sexec, rank0 = None, True
    if sharded:
        mesh = mesh_mod.make_local_mesh(args.groups, args.shard, device.type)
        sexec = shx.plan_for(mesh, require=True, hop_impl=args.hop_impl)
        rank0 = mesh.rank == 0
    say = print if rank0 else (lambda *a, **k: None)
    common = dict(reduced=args.reduced, packed=args.packed, opt=args.opt,
                  lr=args.lr, impl=args.impl, seed=args.seed, device=device)
    if args.mode == "sync":
        cfg, model, layout, step, state = build_sync(args.arch, **common)
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
                    metrics="traj" if args.adaptive_t else "final",
                    shardexec=sexec, **common)
        except (NotImplementedError, ValueError) as e:
            if ap is None:
                raise
            ap.error(str(e))
    n_params = sum(math.prod(d.shape) for d in tree.leaves(model.defs))
    say(f"arch={cfg.name} params={n_params / 1e6:.1f}M mode={args.mode} "
        f"{'packed' if args.packed else 'pytree'} device={device}")
    if sexec is not None:
        say(f"sharded execution: G={args.groups} x {args.shard} shards on "
            f"{args.groups * args.shard} ranks, buffer {layout.size} -> "
            f"{layout.padded} padded ({layout.shard_size}/shard), "
            f"transport {sexec.mesh.transport}")
    # one Trace whether or not --trace is given: the null sink still
    # fences every phase, so the printed times are honest
    trace = obs.Trace(args.trace if rank0 and args.trace else None, meta={
        "arch": cfg.name, "mode": args.mode, "groups": args.groups,
        "t_inner": args.t_inner, "comm": args.comm, "codec": args.codec,
        "rounds": args.rounds, "n_params": n_params,
        "packed": bool(args.packed), "shard": args.shard,
        "overlap": bool(args.overlap), "adaptive_t": args.adaptive_t,
        "drop_rate": args.drop_rate, "stall_rate": args.stall_rate})
    pipe = TokenPipeline(cfg.vocab_size, args.seq, seed=args.seed)
    rng = np.random.RandomState(args.seed)

    def batch_of(batches):
        with trace.phase("data"):
            return add_modalities({"tokens": torch.as_tensor(
                next(batches)["tokens"], device=device)}, cfg, rng)

    if args.mode == "sync":
        batches = pipe.batches((args.groups * args.per_group,))
        with obs.profile_span(args.profile if rank0 else "", device):
            for n in range(args.rounds):
                batch = batch_of(batches)
                with trace.phase("step") as f:
                    state, m = f(step(state, batch))
                rec = trace.emit_round(n, m, kind="step")
                if n % args.log_every == 0:
                    say(f"step {n:4d} loss {float(m['loss']):.4f} "
                          f"gsq {float(m['grad_sq']):.3e} "
                          f"({rec['phase_s'].get('step', 0.0):.2f}s)")
        final = (packing.unpack(state["params"], layout) if args.packed
                 else state["params"])
    else:
        # on a lossy network a useful round costs 1/delivery attempts'
        # worth of link time: r shrinks and the controller's T grows; the
        # online controller refines that prior from the calibrated fences
        ctl = None
        if args.adaptive_t == "online":
            ctl = OnlineT(r=args.cost_ratio * exchange.delivery_rate,
                          t_max=args.t_max)
        elif args.adaptive_t:
            ctl = AdaptiveT(r=args.cost_ratio * exchange.delivery_rate,
                            t_max=args.t_max)
        t_cur = lcfg.inner_steps
        # the exchange-time split calibrates against the packed round's
        # uniform shape; pytree rounds skip it (the report's phase check
        # holds only where the pair is present)
        calibrate = args.packed and (args.overlap or bool(args.trace)
                                     or args.adaptive_t == "online")
        local_ref_step = exch_ref_s = 0.0
        trace.meta.update({"comm": exchange.name,
                           "delivery_rate": exchange.delivery_rate})
        batches = pipe.batches((args.groups, args.per_group))
        wire_total = 0
        with obs.profile_span(args.profile if rank0 else "", device):
            for n in range(args.rounds):
                batch = batch_of(batches)
                if calibrate and n == 0:
                    local_ref_step, exch_ref_s = calibrate_fences(
                        model.loss, optim.get(args.opt, args.lr, packed=True,
                                              impl=args.impl),
                        lcfg, layout, exchange,
                        packing.unpack(state["params"][0], layout)
                        if sexec is None else lsgd.server_params(
                            state, layout, shardexec=sexec),
                        batch, shardexec=sexec)
                    say(f"fences: local {local_ref_step!r} s a step, "
                        f"exchange {exch_ref_s!r} s")
                if ctl is not None and t_cur != lcfg.inner_steps:
                    # a new T: the controller's T for every group, no t_i
                    # and no threshold (as the reference launcher rebuilds)
                    lcfg = lsgd.LocalSGDConfig(
                        n_groups=args.groups, inner_steps=t_cur,
                        max_inner=MAX_INNER, metrics=lcfg.metrics)
                    rnd = rebuild(lcfg)
                if ctl is not None:
                    # before the round: a round that never ends leaves its T
                    say(f"controller: round {n} T {t_cur}", flush=True)
                with trace.phase("round") as f:
                    state, m = f(rnd(state, batch))
                t_used = int(m["inner_steps"].max())
                fences = None
                if calibrate:
                    fences = obs.exchange_phases(
                        trace.phase_seconds("round"),
                        local_ref_step * t_used, exch_ref_s,
                        overlap=args.overlap)
                    for k, v in fences.items():
                        trace.add_phase(k, v)
                if ctl is not None and "grad_sq_traj" in m:
                    traj = m["grad_sq_traj"][0].cpu().numpy()
                    if isinstance(ctl, OnlineT):
                        t_cur = ctl.update(
                            traj, t_used=t_used,
                            local_s=(local_ref_step * t_used) or None,
                            exchange_s=(fences or {}).get(
                                "exchange_total") or None,
                            consensus_pre=float(m["consensus_sq"].mean()),
                            consensus_post=float(
                                m["consensus_sq_post"].mean()),
                            codec_err=sum(float(v.mean())
                                          for k, v in m.items()
                                          if k.startswith("codec_err/")))
                    else:
                        t_cur = ctl.update(traj)
                    if sexec is not None:
                        # rank 0's T: the fenced times differ by rank
                        box = [t_cur]
                        torch.distributed.broadcast_object_list(box, src=0)
                        t_cur = box[0]
                rec = trace.emit_round(n, m)
                wire_total += int(m["wire_bytes"])
                if n % args.log_every == 0:
                    say(f"round {n:4d} "
                        f"loss {float(m['loss'].mean()):.4f} "
                        f"gsq {float(m['grad_sq'].mean()):.3e} "
                        f"T {t_used} "
                        f"wire {int(m['wire_bytes']):,}B "
                        f"part {float(m['participation']):.2f} "
                        f"cons {float(m['consensus_sq'].mean()):.3e} "
                        f"({rec['phase_s'].get('round', 0.0):.2f}s)")
        say(f"comm {exchange.name}: {wire_total:,} wire bytes over "
            f"{args.rounds} rounds")
        # sharded: gathered to the unsharded layout on every rank (a
        # collective)
        final = (lsgd.server_params(state, layout) if sexec is None
                 else lsgd.server_params(state, layout, shardexec=sexec))
    if args.checkpoint and rank0:
        with trace.phase("checkpoint"):
            ckpt_io.save(args.checkpoint, final,
                         metadata={"arch": cfg.name, "rounds": args.rounds,
                                   "mode": args.mode})
        trace.emit("checkpoint", path=args.checkpoint,
                   seconds=round(trace.take_phases()["checkpoint"], 6))
        say(f"checkpoint -> {args.checkpoint}.npz")
    trace.close()
    if args.trace:
        say(f"trace -> {args.trace} ({trace.n_records} records)")


if __name__ == "__main__":
    main()
