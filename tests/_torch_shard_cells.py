"""Rank-side cells of the sharded-execution tests (``tests/
test_torch_shardexec.py``, ``tests/test_torch_shard_exchange.py``): the
port's sharded round and exchange on CPU ranks of one gloo world
(``launch.mesh.run_ranks``). Imports torch and the port only, so the
ranks start without JAX; the tests compare what rank 0 returns (every
buffer gathered to its unsharded (G, Np) shape, as numpy) against the
JAX package.

A cell is a dict with a ``kind`` (``"round"``, ``"exchange"``, ``"mix"``,
``"int8_blocks"``) and its settings; ``noise`` maps ``(codec seed,
count)`` to the reference's int8 noise at the full rows shape, which the
port's codecs draw through their ``noise_fn`` hook. A cell with
``mailbox=True`` runs on the ``cuda-ipc`` transport's mailboxes, here
shared file mappings in place of CUDA IPC (``file_box``), so the
mailbox collectives run on the CPU.
"""
import mmap
import os
import tempfile
import threading

import numpy as np
import torch

from repro_torch import comm, optim, tree
from repro_torch.core import localsgd as lsgd
from repro_torch.launch import mesh as mesh_mod
from repro_torch.optim import packing
from repro_torch.sharding import shardexec as shx

G = 4
MESH8 = (("data", 4), ("model", 2))
MESH_FSDP = (("data", 2), ("fsdp", 2), ("model", 2))


def quad_loss(params, batch):
    """tests/test_shardexec.py's quad_loss."""
    r = batch["A"] @ params["w"] - batch["b"]
    return 0.5 * torch.sum(r ** 2) + 0.1 * torch.sum(params["u"] ** 2)


def problem(seed=0, g=G, r=4, d=6):
    """(params, batch) as numpy float32, tests/test_shardexec.py's
    ``make_problem`` shapes drawn from a RandomState."""
    rng = np.random.RandomState(seed)
    A = (rng.randn(g, r, d) / np.sqrt(d)).astype(np.float32)
    w_star = rng.randn(d).astype(np.float32)
    b = np.einsum("grd,d->gr", A, w_star).astype(np.float32)
    params = {"w": rng.randn(d).astype(np.float32),
              "u": rng.randn(2, 3).astype(np.float32)}
    return params, {"A": A, "b": b}


def sharded_layout(params, n_shards):
    return packing.shard_layout(
        packing.layout_of(tree.tree_map(torch.as_tensor, params)), n_shards)


def table_hook(noise):
    """A ``noise_hook`` reading ``noise[(codec seed, count)]``."""
    def hook(seed):
        def fn(count, shape):
            u = noise[(seed, count)]
            assert u.shape == tuple(shape), (u.shape, shape)
            return u
        return fn

    return hook


def exchange_of(cell, noise):
    """The cell's exchange; int8 draws the reference's noise (given any),
    else the port's own generator."""
    return comm.get_exchange(cell.get("topo", "server"),
                             cell.get("codec", "fp32"), cell.get("G", G),
                             noise_hook=table_hook(noise) if noise else None,
                             **cell.get("ex", {}))


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else x


def gathered(sexec, layout, value):
    """A sharded value at its unsharded shape, as numpy: every (..., 1,
    shard) block gathered to (..., G, Np); host tensors as they are."""
    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.dim() >= 2 and tuple(t.shape[-2:]) == (1, layout.shard_size):
            lead = t.shape[:-2]
            rows = [sexec.gather(b) for b in t.reshape(-1, 1, t.shape[-1])]
            return torch.stack(rows).reshape(*lead, sexec.n_groups,
                                             layout.padded).numpy()
        return t.numpy()

    return tree.tree_map(one, value)


def _round(sexec, cell, noise):
    params, batch = problem(cell.get("seed", 0), g=sexec.n_groups,
                            **cell.get("size", {}))
    layout = sharded_layout(params, sexec.n_shards)
    ex = exchange_of(dict(cell, G=sexec.n_groups), noise)
    opt = optim.get(cell["opt"], cell.get("lr", 0.05), packed=True)
    lcfg = lsgd.LocalSGDConfig(
        n_groups=sexec.n_groups, inner_steps=cell.get("T", 3),
        metrics=cell.get("metrics", "traj"),
        average_opt_state=cell.get("avg_opt", True),
        t_i=cell.get("t_i"))
    rnd = lsgd.make_local_round(quad_loss, opt, lcfg, layout=layout,
                                exchange=ex, shardexec=sexec)
    st = lsgd.init_state(tree.tree_map(torch.as_tensor, params), opt,
                         sexec.n_groups, layout, exchange=ex,
                         average_opt_state=lcfg.average_opt_state,
                         shardexec=sexec)
    tb = tree.tree_map(torch.as_tensor, batch)
    metrics = []
    for _ in range(cell.get("rounds", 3)):
        st, m = rnd(st, tb)
        metrics.append({k: _host(v) for k, v in m.items()})
    out = {"state": gathered(sexec, layout, st), "metrics": metrics,
           "padded": layout.padded, "size": layout.size}
    if cell.get("vs_mix"):
        # the same round with comm none from the same start, then the
        # exchange's codec-free mix by hand
        none = comm.get_exchange("none", "fp32", sexec.n_groups)
        st0 = lsgd.init_state(tree.tree_map(torch.as_tensor, params), opt,
                              sexec.n_groups, layout, shardexec=sexec)
        loc, _ = lsgd.make_local_round(quad_loss, opt, lcfg, layout=layout,
                                       exchange=none, shardexec=sexec)(
            st0, tb)
        mix = sexec.mix(ex)
        out["mixed_locals"] = gathered(sexec, layout, {
            "params": mix(loc["params"]),
            **{k: mix(v) for k, v in loc["opt"].items() if k != "count"}})
    return out


def _exchange(sexec, cell, noise):
    """One ``exchange_streams`` call on full (G, Np) inputs given as
    numpy, each rank on its block (the comm state from ``init``, else
    from ``xs``); ``rounds`` calls in a row."""
    layout = sharded_layout(problem(cell.get("seed", 0))[0], sexec.n_shards)
    ex = exchange_of(dict(cell, G=sexec.n_groups), noise)
    fn = sexec.exchange_streams(ex, layout)
    xs = {k: sexec.local(torch.as_tensor(v), layout)
          for k, v in cell["xs"].items()}
    xs0 = {k: sexec.local(torch.as_tensor(v), layout)
           for k, v in cell["xs0"].items()}
    init = {k: sexec.local(torch.as_tensor(v), layout)
            for k, v in cell.get("init", cell["xs"]).items()}
    st = ex.init(init["params"], moments={k: v for k, v in init.items()
                                          if k != "params"} or None)
    outs = []
    for _ in range(cell.get("rounds", 1)):
        mixed, st = fn(dict(xs), dict(xs0), st)
        outs.append(gathered(sexec, layout, {"mixed": mixed, "state": st}))
        xs = {k: v.clone() for k, v in mixed.items()}
    return outs


def _mix(sexec, cell, noise):
    """``ShardExec.mix`` of a full (G, Np) input given as numpy."""
    layout = sharded_layout(problem(cell.get("seed", 0))[0], sexec.n_shards)
    ex = exchange_of(dict(cell, G=sexec.n_groups), noise)
    x = sexec.local(torch.as_tensor(cell["x"]), layout)
    return gathered(sexec, layout, sexec.mix(ex)(x))


def _int8_blocks(sexec, cell, noise):
    """int8 on each rank's rows of a (G, Np) delta against the whole
    buffer's codec output: the block's rows from the full-shape draw."""
    layout = sharded_layout(problem(cell.get("seed", 0))[0], sexec.n_shards)
    codec = exchange_of(dict(cell, codec="int8", G=sexec.n_groups),
                        noise).codec
    delta = torch.as_tensor(cell["delta"])
    rows = delta.reshape(-1, codec.chunk)
    u = codec.noise(0, tuple(rows.shape), delta.device)
    full = codec.compress_rows(rows, u).reshape(delta.shape)
    rs = layout.shard_size // codec.chunk
    lo = sexec.shard_index * rs
    u_g = u.reshape(sexec.n_groups, -1, codec.chunk)[sexec.group_index]
    got = codec.compress_rows(
        sexec.local(delta, layout).reshape(-1, codec.chunk),
        u_g[lo:lo + rs]).reshape(1, -1)
    return {"blocks": gathered(sexec, layout, got),
            "full": full.numpy()}


CELLS = {"round": _round, "exchange": _exchange, "mix": _mix,
         "int8_blocks": _int8_blocks}


_FILES = []


def file_box(nbytes, device, n_handles):
    """A mailbox of the ``cuda-ipc`` transport on the CPU: a shared
    mapping of a temporary file, its handle the file's path."""
    fd, path = tempfile.mkstemp(prefix="mailbox_")
    try:
        os.ftruncate(fd, nbytes)
        mm = mmap.mmap(fd, nbytes)
    finally:
        os.close(fd)
    _FILES.append(path)
    return (torch.frombuffer(mm, dtype=torch.uint8),
            [(path, nbytes)] * n_handles)


def file_open(handle):
    path, nbytes = handle
    fd = os.open(path, os.O_RDWR)
    try:
        return torch.frombuffer(mmap.mmap(fd, nbytes), dtype=torch.uint8)
    finally:
        os.close(fd)


def rank_cells(rank, world, cells, noise):
    """Every cell on this rank, in order (each cell's mesh built once, by
    every rank in one order); rank 0 returns the results."""
    mesh_mod._ipc_box, mesh_mod._ipc_open = file_box, file_open
    meshes = {}
    out = {}
    for name, cell in cells.items():
        key = (cell.get("mesh", MESH8), bool(cell.get("mailbox")))
        if key not in meshes:
            meshes[key] = mesh_mod.make_mesh(key[0], "cpu")
            if key[1]:
                meshes[key].transport = "cuda-ipc"
        sexec = shx.plan_for(meshes[key], require=True,
                             hop_impl=cell.get("hop_impl", "ppermute"))
        out[name] = CELLS[cell["kind"]](sexec, cell, noise)
    # every rank has mapped every mailbox it reads: the files can go
    torch.distributed.barrier()
    for path in _FILES:
        os.remove(path)
    return out if rank == 0 else None


def run(cells, noise=None, timeout=240.0):
    """All ``cells`` in one world of 8 CPU ranks -> {name: result}."""
    return mesh_mod.run_ranks(rank_cells, 8, cells, noise or {},
                              device_type="cpu", timeout=timeout)[0]


def run_in_background(cells, noise=None, timeout=240.0):
    """``run`` on a thread: returns ``wait() -> {name: result}``, which
    re-raises what the world raised. The ranks are other processes, so
    the caller's own work (the reference's rounds) runs meanwhile."""
    box = {}

    def target():
        try:
            box["out"] = run(cells, noise, timeout)
        except BaseException as e:            # noqa: BLE001 - re-raised
            box["err"] = e

    th = threading.Thread(target=target, daemon=True)
    th.start()

    def wait():
        th.join(timeout + 30.0)
        if "err" in box:
            raise box["err"]
        if "out" not in box:
            raise TimeoutError("the ranks' world did not finish")
        return box["out"]

    return wait
