#!/usr/bin/env python3
"""The sharded round's collectives at paper-lenet's shard size, as
``repro_torch.launch.mesh`` runs them: 8 rank processes sharing one card
(G 4 x S 2, the grid of ``chip_smoke.py`` phase 17; the ``cuda-ipc``
transport), each with a 62,331,392-float block (its shard), time three calls of each
collective the sharded round issues, all 8 ranks at once, fenced on the
card:

- ``Mesh.all_reduce`` over the 4 ranks of one shard index (the G-mean);
- ``Mesh.all_gather`` over the 2 ranks of one group (a step's params
  gather);
- ``Mesh.shift`` by one offset over the group subgroup (a ring hop);

and each rank's CPU seconds (user + system) over the probe. Each rank's
block holds its rank, so every result is checked: the all_reduce the
sum of the members' ranks, the gather each member's rank in its row,
the shift the rank of the next group's shard.

    PYTHONPATH=src python3 tools/torch_mesh_probe.py      # needs a CUDA card
    PYTHONPATH=src python3 tools/torch_mesh_probe.py 2 2  # G 2 x S 2

With ``G S`` the grid is G x S ranks, the block paper-lenet's padded row
over S shards; on a host with a card a rank the transport is NCCL.
Prints the cards' names and power limits, then each collective's seconds
by rank.
"""
import os
import resource
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

ROW = 124_662_784       # paper-lenet's padded row (a multiple of 2 * 256)
G, S = (int(a) for a in sys.argv[1:3]) if len(sys.argv) == 3 else (4, 2)
N = ROW // S            # a shard (62,331,392 floats over 2 shards)
CALLS = 3


def rank_main(rank, world):
    import torch

    from repro_torch.launch import mesh as mesh_mod

    mesh = mesh_mod.make_local_mesh(G, S, "cuda")
    x = torch.full((N,), float(rank), device=mesh.device)
    full = torch.empty((S * N,), device=mesh.device)
    ops = {"all_reduce group": lambda: mesh.all_reduce(x.clone(), "group"),
           "all_gather shard": lambda: mesh.all_gather(x, "shard", out=full),
           "shift 1": lambda: mesh.shift(x, [1])}
    want = {"all_reduce group": [float(sum(mesh.members("group")))],
            "all_gather shard": [float(r) for r in mesh.members("shard")],
            "shift 1": [float(mesh.members("group")[
                (mesh.group_index + 1) % G])]}
    out = {"transport": mesh.transport}
    for name, op in ops.items():
        got = op()                               # the mailboxes grow
        got = torch.stack(list(got)) if isinstance(got, list) else got
        rows = got.reshape(len(want[name]), -1)
        if not all(bool((row == w).all())
                   for row, w in zip(rows, want[name])):
            raise AssertionError(f"rank {rank} {name}: not {want[name]}")
        secs = []
        for _ in range(CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            op()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        out[name] = secs
    r = resource.getrusage(resource.RUSAGE_SELF)
    out["cpu_s"] = r.ru_utime + r.ru_stime
    return out


def main():
    import torch

    from repro_torch.launch import mesh as mesh_mod

    if not torch.cuda.is_available():
        print("torch_mesh_probe: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    res = mesh_mod.run_ranks(rank_main, G * S, device_type="cuda",
                             timeout=300.0)
    print(f"G {G} x S {S}, transport {res[0]['transport']}; block {N} float32 "
          f"({4 * N / 1e6:.1f} MB)")
    for name in ("all_reduce group", "all_gather shard", "shift 1"):
        print(f"{name}: " + "; ".join(
            f"{r}: {[round(x, 5) for x in rec[name]]}"
            for r, rec in enumerate(res)))
    print("cpu s by rank: " + ", ".join(
        f"{rec['cpu_s']:.2f}" for rec in res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
