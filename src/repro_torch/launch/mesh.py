"""The rank grid of sharded execution (counterpart of
``repro/launch/mesh.py``; DESIGN.md §9).

The reference lays a ``(G, S)`` device mesh over TPU chips and runs
``shard_map`` blocks on it. The port runs one process a mesh position:
rank ``r`` of a ``torch.distributed`` world sits at the mesh coordinates
of ``r`` in row-major order over the axes, group axes (``"pod"``,
``"data"``) before the in-group shard axes (``"fsdp"``, ``"model"``).
So with one group axis and one shard axis, rank ``g * S + s`` holds
shard s of group g. Two shard axes flatten into one shard index, major
to minor, as ``SHARD_AXES`` does in ``sharding/shardexec.py``; group
axes flatten into the linear group index alike.

``Mesh`` creates one process subgroup per group-axis slice (all groups,
one shard index) and one per shard-axis slice (one group, all shards);
every rank creates them all, in one order. Its collectives address
them as ``"group"`` and ``"shard"``.

Transport, chosen per host (``LOCAL_WORLD_SIZE`` ranks on this host,
local rank ``LOCAL_RANK`` on ``cuda:(LOCAL_RANK % device_count)``):

- ``"nccl"`` where every rank of the host has a card of its own;
- ``"cuda-ipc"`` where the host's ranks outnumber its cards (8 ranks
  sharing one H100; NCCL refuses two ranks on one device): the world is
  gloo, and every collective goes through each rank's *mailbox*, a
  device buffer the other ranks of the host map with CUDA IPC. A member
  copies its block into its mailbox, a gloo barrier over the subgroup
  says every block is posted, each member copies (or sums, in member
  order, so every member gets the same bits) the blocks it needs from
  the peers' mailboxes, and a second barrier frees the mailboxes for the
  next collective. The blocks stay on the card; gloo carries only the
  handles and the barriers. Every rank runs the same collectives on the
  same shapes, so the mailboxes grow at the same call on every rank. A
  world over several hosts whose ranks share cards is refused: the
  mailboxes reach only the ranks of one host.
- ``"gloo-cpu"`` for ranks on the CPU (``device_type="cpu"``).

``Mesh.transport`` names the one in use; ``Mesh.seconds`` counts the
host seconds a rank spent in its collectives (fenced on the device).

``run_ranks`` starts the ranks of a world on this host (``spawn``), each
joining with an ``init_process_group`` timeout of ``INIT_TIMEOUT_S``,
collects each rank's result, passes a rank's exception back with its
traceback and stops the others, and joins every rank under a deadline,
so a fault fails fast.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing as mp
import os
import queue
import socket
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

GROUP_AXES = ("pod", "data")       # the local-SGD G axis, major to minor
SHARD_AXES = ("fsdp", "model")     # in-group buffer axes, major to minor
INIT_TIMEOUT_S = 120.0             # a collective waiting longer raises
MAILBOX_MIN_BYTES = 1 << 20        # the first mailbox; grown on demand

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
_OPEN: List["Mesh"] = []           # this process's meshes, closed on leaving


def transport_for(local_world: int, world: int, device_type: str) -> str:
    """The transport of a world of ``world`` ranks, ``local_world`` of them
    on this host: ``"nccl"`` where each of them gets a card of its own,
    ``"cuda-ipc"`` where they share this host's cards, ``"gloo-cpu"`` for
    ranks on the CPU."""
    if device_type == "cpu":
        return "gloo-cpu"
    if torch.cuda.device_count() >= local_world:
        return "nccl"
    if local_world != world:
        raise ValueError(
            f"{local_world} ranks share this host's "
            f"{torch.cuda.device_count()} card(s) in a world of {world} "
            "over several hosts; ranks that share a card exchange through "
            "CUDA IPC, which reaches one host only: give each rank a card "
            "(NCCL) or run the world on one host")
    return "cuda-ipc"


def rank_device(local_rank: int, device_type: str) -> torch.device:
    """``cuda:(local_rank % device_count)``, or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def env_ranks() -> Tuple[int, int, int, int]:
    """(rank, world, local rank, local world) of a world its caller
    started (torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``; one host where the last two are not set)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return (rank, world, int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def init_world(rank: int, world: int, init_method: str = "env://",
               device_type: str = "cuda", local_rank: Optional[int] = None,
               local_world: Optional[int] = None) -> torch.device:
    """Join a world with the backend its transport needs; returns this
    rank's device. ``local_rank`` and ``local_world`` default to a world
    on one host (``rank``, ``world``)."""
    local_rank = rank if local_rank is None else local_rank
    local_world = world if local_world is None else local_world
    transport = transport_for(local_world, world, device_type)
    device = rank_device(local_rank, device_type)
    if device_type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if transport == "nccl" else "gloo", init_method=init_method,
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    return device


def leave_world(close: bool = True) -> None:
    """Close this process's meshes (``close``: every rank got here, so the
    mailboxes can go) and leave the world."""
    if close:
        for m in _OPEN:
            m.close()
    _OPEN.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def _ipc_box(nbytes: int, device: torch.device, n_handles: int):
    """A mailbox of ``nbytes`` on ``device`` and ``n_handles`` CUDA IPC
    handles to it, one a peer (each peer releases its own reference)."""
    from torch.multiprocessing.reductions import reduce_tensor
    box = torch.empty(nbytes, dtype=torch.uint8, device=device)
    return box, [reduce_tensor(box) for _ in range(n_handles)]


def _ipc_open(handle) -> torch.Tensor:
    """A peer's mailbox, mapped into this process."""
    rebuild, args = handle
    return rebuild(*args)


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a ``(group axes..., shard axes...)`` grid over
    the current world, with the subgroups of both kinds."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    rank: int
    device: torch.device
    transport: str
    n_groups: int
    n_shards: int
    group_index: int
    shard_index: int
    _groups: Dict[str, object] = dataclasses.field(repr=False)
    # host seconds spent in this rank's collectives (read by the chip
    # smoke test's timings)
    seconds: float = 0.0
    # cuda-ipc: this rank's mailbox and the peers' (mapped), by rank
    _box: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                     repr=False)
    _peers: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict,
                                                        repr=False)

    def rank_of(self, group: int, shard: int) -> int:
        """The global rank holding ``shard`` of ``group``."""
        return group * self.n_shards + shard

    def members(self, axis: str) -> List[int]:
        """The global ranks of this rank's ``axis`` subgroup, in their
        index order on the axis."""
        if axis == "group":
            return [self.rank_of(g, self.shard_index)
                    for g in range(self.n_groups)]
        return [self.rank_of(self.group_index, s)
                for s in range(self.n_shards)]

    def _tick(self, t0: float) -> None:
        if self.transport == "nccl":
            # NCCL runs asynchronously to the host: fence, so the seconds
            # are the collective's
            self._sync()
        self.seconds += time.perf_counter() - t0

    def _sync(self) -> None:
        """Wait, asleep, for this rank's queued work on its card (a
        spinning wait would hold a host core while the ranks sharing the
        card keep it busy)."""
        if self.device.type == "cuda":
            done = torch.cuda.Event(blocking=True)
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()

    # -- cuda-ipc: mailboxes on the card ------------------------------------

    def _grow(self, nbytes: int) -> None:
        """Every rank's mailbox to ``nbytes``, the handles swapped over the
        world (every rank grows at the same collective). A rank's peers,
        the other members of its two subgroups, are the ranks whose
        mailboxes it reads and that read its own: each gets a handle."""
        peers = sorted((set(self.members("group"))
                        | set(self.members("shard"))) - {self.rank})
        self._peers.clear()
        self._box, mine = _ipc_box(nbytes, self.device, len(peers))
        handles = [None] * dist.get_world_size()
        dist.all_gather_object(handles, dict(zip(peers, mine)))
        self._peers = {r: _ipc_open(handles[r][self.rank]) for r in peers}
        self._peers[self.rank] = self._box

    def _post(self, t: torch.Tensor, axis: str) -> List[torch.Tensor]:
        """``t`` into this rank's mailbox; once every member of the ``axis``
        subgroup has posted, each member's block (views of the mailboxes,
        in member order)."""
        nbytes = t.numel() * t.element_size()
        if self._box is None or nbytes > self._box.numel():
            self._grow(max(nbytes, MAILBOX_MIN_BYTES))

        def block(box):
            return box[:nbytes].view(t.dtype).view(t.shape)

        block(self._box).copy_(t)
        self._sync()
        dist.barrier(group=self._groups[axis])
        return [block(self._peers[r]) for r in self.members(axis)]

    def _release(self, axis: str) -> None:
        """Every member of ``axis`` has read the blocks it needs."""
        self._sync()
        dist.barrier(group=self._groups[axis])

    def close(self) -> None:
        """Unmap the peers' mailboxes and free this rank's (a collective of
        the whole world on ``cuda-ipc``, else nothing)."""
        if self._box is None:
            return
        self._sync()
        dist.barrier()
        self._peers.clear()
        dist.barrier()
        self._box = None

    # -- collectives ----------------------------------------------------------

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where NCCL can take it: a host tensor copied to the card."""
        if self.transport == "nccl" and not t.is_cuda:
            return t.to(self.device)
        return t

    def all_reduce(self, t: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` in place over the ``axis`` subgroup; returns it.
        Every member gets the same bits."""
        t0 = time.perf_counter()
        if self.transport == "cuda-ipc":
            blocks = self._post(t, axis)
            acc = t if t.device == self.device else torch.empty(
                t.shape, dtype=t.dtype, device=self.device)
            acc.copy_(blocks[0])
            for b in blocks[1:]:
                if op == "sum":
                    acc.add_(b)
                else:
                    torch.maximum(acc, b, out=acc)
            self._release(axis)
            if acc is not t:
                t.copy_(acc)
        else:
            w = self._wire(t)
            dist.all_reduce(w, op=_OPS[op], group=self._groups[axis])
            if w is not t:
                t.copy_(w)
        self._tick(t0)
        return t

    def all_gather(self, t: torch.Tensor, axis: str,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The members' ``t`` stacked along a new leading axis, in the
        order of their index on ``axis`` (into ``out`` when given, a
        tensor of ``(k,) + t.shape`` elements on ``t``'s device)."""
        t0 = time.perf_counter()
        k = self.n_groups if axis == "group" else self.n_shards
        shape = (k,) + tuple(t.shape)
        if out is None:
            out = torch.empty(shape, dtype=t.dtype, device=t.device)
        out = out.view(shape)
        if self.transport == "cuda-ipc":
            for o, b in zip(out.unbind(0), self._post(t, axis)):
                o.copy_(b)
            self._release(axis)
        else:
            w_in = self._wire(t.contiguous())
            w_out = out if w_in.device == out.device else torch.empty(
                shape, dtype=t.dtype, device=w_in.device)
            dist.all_gather(list(w_out.unbind(0)), w_in,
                            group=self._groups[axis])
            if w_out is not out:
                out.copy_(w_out)
        self._tick(t0)
        return out

    def shift(self, t: torch.Tensor, offsets: Sequence[int]) -> list:
        """Point-to-point over the group subgroup: for each offset d,
        receive the block of group ``(g + d) % G`` (``permute`` by the
        uniform map ``src_of[g] = (g + d) % G``)."""
        G = self.n_groups
        return self.permute(t, [[(j + d) % G for j in range(G)]
                                for d in offsets])

    def permute(self, t: torch.Tensor,
                src_ofs: Sequence[Sequence[int]]) -> list:
        """Point-to-point over the group subgroup by permutations of the
        groups: for each map ``src_of``, member g receives the block of
        group ``src_of[g]`` and sends this block to the group that reads
        it (the inverse permutation). Returns the received blocks, one
        per map, on ``t``'s device; every map goes in one post (cuda-ipc)
        or one batch of sends and receives."""
        t0 = time.perf_counter()
        G, g, s = self.n_groups, self.group_index, self.shard_index
        for src_of in src_ofs:
            if sorted(src_of) != list(range(G)):
                raise ValueError(f"src_of {list(src_of)} is no permutation "
                                 f"of the {G} groups")
        out = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
               for _ in src_ofs]
        if self.transport == "cuda-ipc":
            blocks = self._post(t, "group")
            for o, src_of in zip(out, src_ofs):
                o.copy_(blocks[src_of[g]])
            self._release("group")
            self._tick(t0)
            return out
        grp = self._groups["group"]
        src = self._wire(t.contiguous())
        recvs, ops = [], []
        for o, src_of in zip(out, src_ofs):
            if src_of[g] == g:
                o.copy_(t)
                continue
            r = o if o.device == src.device else torch.empty(
                t.shape, dtype=t.dtype, device=src.device)
            if r is not o:
                recvs.append((o, r))
            ops.append(dist.P2POp(dist.isend, src,
                                  self.rank_of(list(src_of).index(g), s),
                                  grp))
            ops.append(dist.P2POp(dist.irecv, r, self.rank_of(src_of[g], s),
                                  grp))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for o, r in recvs:
            o.copy_(r)
        self._tick(t0)
        return out


def make_mesh(axes: Sequence[Tuple[str, int]],
              device_type: Optional[str] = None) -> Mesh:
    """The grid ``axes`` (``(name, size)`` pairs, major to minor: group
    axes, then shard axes) over the current world, whose size must be
    the grid's. Every rank must call it, with the same axes, in the same
    order as its other ``new_group`` calls."""
    names = tuple(a for a, _ in axes)
    shape = dict(axes)
    known = GROUP_AXES + SHARD_AXES
    if any(a not in known for a in names) or len(set(names)) != len(names):
        raise ValueError(f"mesh axes {names}: each one of {known}, once")
    order = [known.index(a) for a in names]
    if order != sorted(order):
        raise ValueError(f"mesh axes {names} must run {known} in that order "
                         "(group axes before shard axes)")
    world = dist.get_world_size()
    if math.prod(shape.values()) != world:
        raise ValueError(f"mesh {shape} holds {math.prod(shape.values())} "
                         f"ranks, the world {world}")
    rank = dist.get_rank()
    n_groups = math.prod(shape[a] for a in names if a in GROUP_AXES)
    n_shards = world // n_groups
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type == "cpu":
        device, transport = torch.device("cpu"), "gloo-cpu"
    else:
        # init_world set this rank's card and chose the backend
        device = torch.device("cuda", torch.cuda.current_device())
        transport = "nccl" if dist.get_backend() == "nccl" else "cuda-ipc"
    groups = {}
    # one order on every rank: the group-axis slices by shard index,
    # then the shard-axis slices by group index
    for s in range(n_shards):
        pg = dist.new_group([g * n_shards + s for g in range(n_groups)])
        if rank % n_shards == s:
            groups["group"] = pg
    for g in range(n_groups):
        pg = dist.new_group([g * n_shards + s for s in range(n_shards)])
        if rank // n_shards == g:
            groups["shard"] = pg
    mesh = Mesh(axis_names=names, shape=shape, rank=rank, device=device,
                transport=transport, n_groups=n_groups, n_shards=n_shards,
                group_index=rank // n_shards, shard_index=rank % n_shards,
                _groups=groups)
    _OPEN.append(mesh)
    return mesh


def make_local_mesh(data: int = 1, model: int = 1,
                    device_type: Optional[str] = None) -> Mesh:
    """``(data, model)`` over the current world of ``data * model`` ranks:
    ``data`` groups of ``model`` shards."""
    return make_mesh((("data", data), ("model", model)), device_type)


def make_production_mesh(*, multi_pod: bool = False, fsdp: int = 1):
    """The reference's TPU v5e pod meshes (256 and 512 chips) describe
    hardware the port does not target; they wait for the dry-run tools."""
    raise NotImplementedError(
        "make_production_mesh describes TPU v5e pods; the port has no "
        "counterpart yet (ROADMAP.md Queue A item 7)")


# ---------------------------------------------------------------------------
# Starting the ranks of a world on this host
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank, world, init_method, device_type, args, results):
    torch.set_num_threads(1)
    ok = False
    try:
        init_world(rank, world, init_method, device_type)
        results.put((rank, True, fn(rank, world, *args)))
        ok = True
    except BaseException:                  # noqa: BLE001 - passed back
        results.put((rank, False, traceback.format_exc()))
    finally:
        leave_world(close=ok)


def run_ranks(fn, world: int, *args, device_type: str = "cuda",
              timeout: float = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` new processes joined in
    one world on this host; returns their results in rank order. ``fn``
    must be importable (a module's top-level function) and its result
    picklable. A rank that raises, or dies, fails the call at once with
    its traceback, and every other rank is stopped; so does the
    ``timeout`` (seconds, for the whole world)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(fn, r, world, init_method, device_type,
                               args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout
    try:
        while len(out) < world:
            try:
                rank, ok, val = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(out))} of "
                        f"{world} gave no result within {timeout:.0f} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{val}")
            out[rank] = val
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
    return [out[r] for r in range(world)]
