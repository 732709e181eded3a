"""The port's sharded execution (``repro_torch.sharding.shardexec``,
``launch/mesh.py``, ``packing.ShardedLayout``) against the JAX package,
mirroring ``tests/test_shardexec.py``.

The sharded cells run in one world of 8 gloo ranks on the CPU (G 4 x S 2,
and a (data 2, fsdp 2, model 2) mesh), started once for the module
(``_torch_shard_cells.run``); rank 0 returns every buffer gathered to its
unsharded (G, Np) shape. They are held against the reference's
replicated packed round on the same ``ShardedLayout`` (jitted on the
CPU), int8 drawing the reference's noise through the port's noise hook:

- params and every moment stream within 1e-5 relative of the largest
  element (the mean's all_reduce sums in another order; DESIGN.md §9);
  the traj ``grad_sq`` and the loss within rtol 1e-4; wire bytes, the
  codec counters and the round counter exact;
- the int8 codec's blocks bit-equal to the whole buffer's codec output,
  and to the reference's;
- the ppermute hop bit-equal to the allgather hop; the fp32 moments
  bit-equal to ``ShardExec.mix`` of the no-comm locals;
- one cell (server fp32 adamw) against the reference's own sharded round,
  run in a child process with 8 forced host devices;
- the ``cuda-ipc`` transport's mailbox collectives (file mappings in
  place of CUDA IPC on the CPU) on three cells: the same holds, within
  1e-5 relative of the gloo world's round, its two hops bit-equal.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_shard_cells as C
from repro import comm as jcomm
from repro import optim as joptim
from repro.comm import codecs as jcodecs
from repro.comm import faults as jfaults
from repro.core import localsgd as jlsgd
from repro.optim import packing as jpacking
from repro_torch import comm, optim, tree
from repro_torch.comm import codecs, faults
from repro_torch.core import localsgd as lsgd
from repro_torch.launch import mesh as mesh_mod
from repro_torch.optim import packing
from repro_torch.sharding import shardexec as shx

G = C.G
REL = 1e-5
OPTS = ("sgd", "momentum", "adamw")
HERE = os.path.dirname(os.path.abspath(__file__))


def quad_loss_j(params, batch):
    r = batch["A"] @ params["w"] - batch["b"]
    return 0.5 * jnp.sum(r ** 2) + 0.1 * jnp.sum(params["u"] ** 2)


def noise_table(g=G, n_shards=2, counts=8, lanes=("params", "moments")):
    """The reference's int8 noise at the (G, Np) rows shape, per codec
    seed lane and count."""
    params, _ = C.problem(g=g)
    rows = (g * C.sharded_layout(params, n_shards).padded // 256, 256)
    out = {}
    for lane in lanes:
        seed = jfaults.codec_seed(0, lane)
        ref = jcodecs.int8(seed=seed, impl="jnp")
        for c in range(counts):
            out[(seed, c)] = np.asarray(ref.noise(jnp.int32(c), rows))
    return out


def ref_round(cell, n_shards=2):
    """The reference's replicated packed round on the cell's settings, on
    its ShardedLayout: (state, per-round metrics) as numpy."""
    g = cell.get("G", G)
    params, batch = C.problem(cell.get("seed", 0), g=g)
    jp = jax.tree.map(jnp.asarray, params)
    layout = jpacking.shard_layout(jpacking.layout_of(jp), n_shards)
    ex = jcomm.get_exchange(cell.get("topo", "server"),
                            cell.get("codec", "fp32"), g, impl="jnp",
                            **cell.get("ex", {}))
    opt = joptim.get(cell["opt"], cell.get("lr", 0.05), packed=True,
                     impl="jnp")
    avg = cell.get("avg_opt", True)
    cfg = jlsgd.LocalSGDConfig(n_groups=g, inner_steps=cell.get("T", 3),
                               metrics=cell.get("metrics", "traj"),
                               average_opt_state=avg)
    rnd = jax.jit(jlsgd.make_local_round(quad_loss_j, opt, cfg,
                                         layout=layout, exchange=ex))
    st = jlsgd.init_state(jp, opt, n_groups=g, layout=layout, exchange=ex,
                          average_opt_state=avg)
    jb = jax.tree.map(jnp.asarray, batch)
    ms = []
    for _ in range(cell.get("rounds", 3)):
        st, m = rnd(st, jb)
        ms.append(jax.device_get(m))
    return jax.device_get(st), ms


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


# the cells of the module's one world
PARITY = {f"{o}-{t}-{c}": dict(kind="round", opt=o, topo=t, codec=c,
                               ex=dict(mix_rounds=2))
          for o in OPTS for t in ("server", "ring") for c in ("fp32", "int8")}
STREAMS = {f"streams-{o}-{t}": dict(kind="round", opt=o, topo=t,
                                    codec="int8", lr=0.03,
                                    ex=dict(mix_rounds=2,
                                            moment_codec="int8"))
           for o in ("momentum", "adamw") for t in ("server", "ring")}
OTHER = {
    "async": dict(kind="round", opt="sgd", topo="async_stale", T=2,
                  rounds=4, avg_opt=False, metrics="final",
                  ex=dict(staleness=1)),
    "async-avg": dict(kind="round", opt="momentum", topo="async_stale",
                      T=2, rounds=4, metrics="final",
                      ex=dict(staleness=1)),
    "fsdp": dict(kind="round", opt="momentum", T=2, rounds=1,
                 metrics="final", mesh=C.MESH_FSDP),
    "vs-mix": dict(kind="round", opt="momentum", T=2, rounds=1,
                   metrics="final", vs_mix=True),
    "hop-allgather": dict(kind="round", opt="sgd", topo="ring",
                          codec="int8", hop_impl="allgather",
                          ex=dict(mix_rounds=2)),
    "gossip-ppermute": dict(kind="round", opt="momentum", topo="gossip",
                            codec="bf16", rounds=2,
                            ex=dict(mix_rounds=2, moment_codec="int8")),
    "gossip-allgather": dict(kind="round", opt="momentum", topo="gossip",
                             codec="bf16", hop_impl="allgather", rounds=2,
                             ex=dict(mix_rounds=2, moment_codec="int8")),
}

# the cuda-ipc transport's mailboxes: each cell as its gloo twin
MAILBOX = {"mailbox-adamw-server-int8": "adamw-server-int8",
           "mailbox-sgd-ring-int8": "sgd-ring-int8",
           "mailbox-hop-allgather": "hop-allgather"}


def _delta(seed=3):
    params, _ = C.problem()
    padded = C.sharded_layout(params, 2).padded
    return (np.random.RandomState(seed).randn(G, padded) * 0.1).astype(
        np.float32)


def _exchange_inputs(seed=4):
    params, _ = C.problem()
    x0 = np.asarray(packing.pack(
        tree.tree_map(lambda a: torch.as_tensor(a)[None].repeat(
            G, *([1] * a.ndim)), params),
        C.sharded_layout(params, 2)))
    x = x0 + _delta(seed)
    x[:, C.sharded_layout(params, 2).size:] = 0.0
    return x, x0


@pytest.fixture(scope="module")
def noise():
    return noise_table()


@pytest.fixture(scope="module")
def child():
    """The reference's own sharded round (server fp32 adamw), in a child
    process with 8 forced host devices, started before the world."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        + env.get("XLA_FLAGS", "")).strip()
    env["JAX_PLATFORMS"] = "cpu"
    out = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                       f"ref_sharded_{os.getpid()}.npz")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_ref_sharded_round.py"), out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
    if os.path.exists(out):
        os.remove(out)


FSDP = dict(OTHER["fsdp"], G=2)


@pytest.fixture(scope="module")
def world(noise, child):
    """The world's results and, computed while its ranks run, the
    reference's rounds of every round cell."""
    x, x0 = _exchange_inputs()
    cells = dict(PARITY, **STREAMS, **OTHER)
    cells.update({k: dict(cells[v], mailbox=True)
                  for k, v in MAILBOX.items()})
    cells["int8-blocks"] = dict(kind="int8_blocks", delta=_delta())
    cells["int8-exchange"] = dict(kind="exchange", codec="int8",
                                  xs={"params": x}, xs0={"params": x0})
    out = C.run_in_background(cells, noise)
    refs = {name: ref_round(cell) for name, cell in cells.items()
            if cell["kind"] == "round" and name not in (
                "fsdp", "hop-allgather", "gossip-allgather")
            and name not in MAILBOX}
    refs["fsdp"] = ref_round(FSDP, n_shards=4)
    got = out()
    got["refs"] = refs
    return got


def _hold_round(got, cell, ref):
    st_r, ms_r = ref
    st = got["state"]
    assert rel_err(st["params"], st_r["params"]) <= REL
    for k, v in st_r["opt"].items():
        if k == "count":
            assert int(np.asarray(st["opt"][k])) == int(v)
        else:
            assert rel_err(st["opt"][k], v) <= REL, k
    for m, m_r in zip(got["metrics"], ms_r):
        np.testing.assert_allclose(m["loss"], m_r["loss"], rtol=1e-4)
        key = "grad_sq_traj" if "grad_sq_traj" in m_r else "grad_sq"
        np.testing.assert_allclose(m[key], m_r[key], rtol=1e-4, atol=1e-8)
        for k in m_r:
            if k.startswith("wire_bytes"):
                assert int(m[k]) == int(m_r[k]), k
        np.testing.assert_array_equal(m["inner_steps"], m_r["inner_steps"])
    for k, cs in st_r.get("comm", {}).get("codec", {}).items():
        if "count" in cs:
            assert int(np.asarray(st["comm"]["codec"][k]["count"])) \
                == int(cs["count"]), k
    return st, st_r


# ---------------------------------------------------------------------------
# ShardedLayout and the guards (no world)
# ---------------------------------------------------------------------------


def test_shard_layout_roundtrip_with_padding():
    params, _ = C.problem()
    tp = tree.tree_map(torch.as_tensor, params)
    base = packing.layout_of(tp)
    layout = packing.shard_layout(base, n_shards=2, align=256)
    ref = jpacking.shard_layout(jpacking.layout_of(
        jax.tree.map(jnp.asarray, params)), 2, align=256)
    assert (layout.padded, layout.shard_size, layout.size) == (
        ref.padded, ref.shard_size, ref.size)
    assert layout.padded % (2 * 256) == 0 and layout.padded > base.size
    buf = packing.pack(tp, layout)
    assert buf.shape == (layout.padded,)
    np.testing.assert_array_equal(buf[base.size:].numpy(), 0.0)
    np.testing.assert_array_equal(
        buf.numpy(), np.asarray(jpacking.pack(
            jax.tree.map(jnp.asarray, params), ref)))
    back = packing.unpack(buf, layout)
    for a, b in zip(tree.leaves(tp), tree.leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    buf_G = packing.pack(lsgd.replicate(tp, 3), layout)
    assert buf_G.shape == (3, layout.padded)
    # the packed gradient's pad is zero too
    flat_vg = packing.value_and_flat_grad(C.quad_loss, layout)
    _, g = flat_vg(buf, tree.tree_map(lambda a: torch.as_tensor(a[0]),
                                      C.problem()[1]),
                   out=torch.full((layout.padded,), 7.0))
    np.testing.assert_array_equal(g[base.size:].numpy(), 0.0)


def test_shard_layout_pad_stays_zero_through_updates():
    params, _ = C.problem()
    tp = tree.tree_map(torch.as_tensor, params)
    layout = packing.shard_layout(packing.layout_of(tp), 2, align=64)
    g = packing.pack(tree.tree_map(torch.ones_like, tp), layout)
    for name in OPTS:
        opt = optim.get(name, 0.1, packed=True)
        b = packing.pack(tp, layout)
        state = opt.init(b)
        for _ in range(3):
            b, state = opt.step(b, g, state)
        np.testing.assert_array_equal(b[layout.size:].numpy(), 0.0)


def fake_mesh(shape=(("data", 1), ("model", 1))):
    """A Mesh of one rank with no process group: enough for the plan and
    for what refuses before any collective."""
    sh = dict(shape)
    return mesh_mod.Mesh(axis_names=tuple(sh), shape=sh, rank=0,
                         device=torch.device("cpu"), transport="gloo-cpu",
                         n_groups=1, n_shards=1, group_index=0,
                         shard_index=0, _groups={})


def fake_plan(**kw):
    return shx.ShardExec(mesh=fake_mesh(), group_axes=("data",),
                         shard_axes=("model",), **kw)


def test_plan_and_layout_guards():
    params, _ = C.problem()
    base = packing.layout_of(tree.tree_map(torch.as_tensor, params))
    assert shx.plan_for(fake_mesh()) is None
    with pytest.raises(ValueError):
        shx.plan_for(fake_mesh(), require=True)
    plan = shx.plan_for(fake_mesh((("data", 4), ("model", 2))))
    assert (plan.group_axes, plan.shard_axes) == (("data",), ("model",))
    assert (plan.n_groups, plan.n_shards) == (4, 2)
    plan = shx.plan_for(fake_mesh((("data", 2), ("fsdp", 2),
                                   ("model", 2))))
    assert plan.shard_axes == ("fsdp", "model") and plan.n_shards == 4
    fake = fake_plan()
    with pytest.raises(ValueError):
        fake.check_layout(base)                       # a plain Layout
    with pytest.raises(ValueError):
        fake.check_layout(packing.shard_layout(base, 4))  # shard count
    with pytest.raises(ValueError):                   # chunk alignment
        fake.check_layout(packing.shard_layout(base, 1, align=8), chunk=256)
    with pytest.raises(ValueError):
        fake_plan(hop_impl="bogus")
    with pytest.raises(ValueError):                   # axes out of order
        mesh_mod.make_mesh((("model", 2), ("data", 4)))
    with pytest.raises(NotImplementedError, match="item 7"):
        mesh_mod.make_production_mesh()


def test_sharded_path_refusals():
    """The reference's refusals, the two tiers' among them. top-k is not
    refused: it shards by the threshold selection; nor are the two tiers
    and overlap themselves."""
    params, _ = C.problem()
    fake = fake_plan()
    layout = packing.shard_layout(
        packing.layout_of(tree.tree_map(torch.as_tensor, params)), 1)
    fake.exchange(comm.get_exchange("server", "topk", G), layout)
    refused = [
        comm.get_exchange("server", "fp32", G, downlink_codec="bf16"),
        dataclasses.replace(comm.get_exchange("async_stale", "fp32", G),
                            codec=codecs.get_codec("topk")),
        dataclasses.replace(comm.get_exchange("push_sum", "fp32", G),
                            codec=codecs.get_codec("int8")),
        dataclasses.replace(comm.get_exchange("server", "int8", G),
                            codec=dataclasses.replace(
                                codecs.get_codec("int8"), shardable=False)),
    ]
    for ex in refused:
        with pytest.raises(NotImplementedError):
            fake.exchange(ex, layout)
    hier = comm.get_exchange("hierarchical", "fp32", G, n_pods=2)
    int8 = codecs.get_codec("int8")
    tiers = [
        (dataclasses.replace(hier, fault_plan=faults.FaultPlan(
            seed=0, drop_rate=0.1)),
         "TieredFaultPlan"),
        (dataclasses.replace(hier, codec=int8), "intra tier"),
        (dataclasses.replace(hier, inter_codec=int8), "push_sum inter tier"),
    ]
    for ex, what in tiers:
        with pytest.raises(NotImplementedError, match=what):
            fake.exchange_streams(ex, layout)
        with pytest.raises(NotImplementedError, match=what):
            shx.check_exchange(ex)
    # the tiers and overlap build on a shard
    overlap = comm.get_exchange("ring", "int8", G, overlap=True)
    for ex in (hier, comm.get_exchange(
            "hierarchical", "fp32", G, n_pods=2, intra_topology="server",
            inter_topology="server", inter_codec="int8"), overlap):
        shx.check_exchange(ex)
    fake.exchange_streams(hier, layout)
    fake.mix_streams(overlap)
    fake.encode_streams(overlap, layout)


def test_transport_and_device_by_host(monkeypatch):
    """NCCL where each rank of a host has a card of its own, whatever the
    world's size; CUDA IPC mailboxes where the host's ranks share its
    cards; refused where ranks share cards across hosts. A rank's card
    is its local rank's."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert mesh_mod.transport_for(8, 16, "cuda") == "nccl"     # 2 x 8
    assert mesh_mod.transport_for(4, 4, "cuda") == "nccl"
    monkeypatch.setenv("RANK", "11")
    monkeypatch.setenv("WORLD_SIZE", "16")
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    rank, world, local_rank, local_world = mesh_mod.env_ranks()
    assert (rank, world, local_rank, local_world) == (11, 16, 3, 8)
    assert mesh_mod.rank_device(local_rank, "cuda") == torch.device(
        "cuda", 3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh_mod.transport_for(8, 8, "cuda") == "cuda-ipc"
    assert mesh_mod.transport_for(1, 4, "cuda") == "nccl"
    with pytest.raises(ValueError, match="one host"):
        mesh_mod.transport_for(8, 16, "cuda")
    assert mesh_mod.rank_device(5, "cuda") == torch.device("cuda", 0)
    assert mesh_mod.transport_for(8, 16, "cpu") == "gloo-cpu"
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    assert mesh_mod.env_ranks() == (11, 16, 11, 16)


def test_shardexec_needs_packed_path():
    fake = fake_plan()
    params, _ = C.problem()
    layout = packing.shard_layout(
        packing.layout_of(tree.tree_map(torch.as_tensor, params)), 1)
    cfg = lsgd.LocalSGDConfig(n_groups=G, inner_steps=2)
    with pytest.raises(ValueError):
        lsgd.make_local_round(C.quad_loss, optim.sgd(0.1), cfg,
                              shardexec=fake)
    # per-node t_i with a count-dependent update (reference :519-523)
    cfg_t = lsgd.LocalSGDConfig(n_groups=G, inner_steps=2, t_i=(1, 2, 2, 2))
    with pytest.raises(NotImplementedError):
        lsgd.make_local_round(C.quad_loss, optim.get(
            "adamw", 0.1, packed=True), cfg_t, layout=layout,
            shardexec=fake)


# ---------------------------------------------------------------------------
# The 8-rank world against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PARITY))
def test_sharded_round_parity(world, name):
    """THE gate: 3 sharded rounds (kernels' plain versions on the shards)
    against the reference's replicated round on the same padded layout:
    sgd/momentum/adamw x server/ring x fp32/int8."""
    st, _ = _hold_round(world[name], PARITY[name], world["refs"][name])
    pad = world[name]["size"]
    np.testing.assert_array_equal(st["params"][:, pad:], 0.0)


def test_sharded_int8_codec_bit_identical(world):
    """Each rank's int8 rows, decoded with its slice of the full-shape
    noise, are the whole buffer's codec output bit for bit, and the
    reference's."""
    got = world["int8-blocks"]
    np.testing.assert_array_equal(got["blocks"], got["full"])
    delta = _delta()
    codec = jcodecs.int8(seed=jfaults.codec_seed(0, "params"), impl="jnp")
    rows = delta.reshape(-1, 256)
    ref = codec.compress_rows(jnp.asarray(rows),
                              codec.noise(jnp.int32(0), rows.shape))
    np.testing.assert_array_equal(got["full"],
                                  np.asarray(ref).reshape(delta.shape))


def test_sharded_int8_exchange_matches_replicated(world):
    """One sharded server int8 exchange against the reference's: the same
    codec bits, the mean in another order."""
    x, x0 = _exchange_inputs()
    ex = jcomm.get_exchange("server", "int8", G, impl="jnp")
    out_r, st_r = jax.jit(ex.params)(jnp.asarray(x), jnp.asarray(x0),
                                     ex.init(jnp.asarray(x0)))
    got = world["int8-exchange"][0]
    np.testing.assert_allclose(got["mixed"]["params"], np.asarray(out_r),
                               rtol=1e-6, atol=1e-7)
    assert int(got["state"]["codec"]["params"]["count"]) \
        == int(st_r["codec"]["params"]["count"]) == 1


def test_sharded_async_stale_parity(world):
    """async_stale: the staleness buffer shards like the params."""
    st, st_r = _hold_round(world["async"], OTHER["async"],
                           world["refs"]["async"])
    assert int(st["comm"]["round"]) == int(st_r["comm"]["round"]) == 4
    np.testing.assert_allclose(st["comm"]["pushed"], st_r["comm"]["pushed"],
                               rtol=1e-5, atol=1e-7)


def test_sharded_async_avg_opt_parity(world):
    """async_stale averaging the moments: per-stream staleness buffers."""
    st, st_r = _hold_round(world["async-avg"], OTHER["async-avg"],
                           world["refs"]["async-avg"])
    assert set(st["comm"]["pushed_opt"]) == {"mu"}
    for a, b in ((st["comm"]["pushed"], st_r["comm"]["pushed"]),
                 (st["comm"]["pushed_opt"]["mu"],
                  st_r["comm"]["pushed_opt"]["mu"])):
        assert rel_err(a, b) <= REL
    assert int(st["comm"]["round"]) == 4


def test_sharded_parity_fsdp_mesh(world):
    """(data 2, fsdp 2, model 2): the buffer shards 4-way over both
    in-group axes."""
    _hold_round(world["fsdp"], FSDP, world["refs"]["fsdp"])


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_sharded_stream_parity_moment_codec(world, name):
    """The moments on their own int8 codec (the moments lane's noise)."""
    st, _ = _hold_round(world[name], STREAMS[name], world["refs"][name])
    assert set(st["comm"]["codec"]) == {"params"} | set(
        k for k in st["opt"] if k != "count")


def test_sharded_fp32_moments_bit_exact_vs_mix(world):
    """With fp32 streams the round's exchange is ``ShardExec.mix``'s ops:
    the round's params and moments equal the mix of the no-comm locals
    bit for bit."""
    got = world["vs-mix"]
    st = got["state"]
    np.testing.assert_array_equal(st["params"],
                                  got["mixed_locals"]["params"])
    np.testing.assert_array_equal(st["opt"]["mu"], got["mixed_locals"]["mu"])
    _hold_round(got, OTHER["vs-mix"], world["refs"]["vs-mix"])


@pytest.mark.parametrize("pair", [("ring-ppermute", "ring-allgather"),
                                  ("gossip-ppermute", "gossip-allgather")])
def test_ppermute_hop_bit_equal_allgather(world, pair):
    """The point-to-point hop and the dense hop assemble the same (G,
    shard) rows: every stream of the round bit-equal."""
    names = {"ring-ppermute": "sgd-ring-int8",
             "ring-allgather": "hop-allgather"}
    a, b = (world[names.get(n, n)]["state"] for n in pair)
    for k in ("params",):
        np.testing.assert_array_equal(a[k], b[k])
    for k, v in a["opt"].items():
        np.testing.assert_array_equal(v, b["opt"][k])
    if pair[0].startswith("gossip"):
        _hold_round(world["gossip-ppermute"], OTHER["gossip-ppermute"],
                    world["refs"]["gossip-ppermute"])


def test_reference_sharded_round_forced_8_devices(world, child):
    """server fp32 adamw against the reference's own sharded round
    (shard_map on 8 forced host devices)."""
    proc, out = child
    log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log[-4000:]
    ref = np.load(out)
    st = world["adamw-server-fp32"]["state"]
    for k, v in (("params", st["params"]), ("m", st["opt"]["m"]),
                 ("v", st["opt"]["v"])):
        assert rel_err(v, ref[k]) <= REL, k
    np.testing.assert_allclose(
        world["adamw-server-fp32"]["metrics"][-1]["grad_sq_traj"],
        ref["grad_sq_traj"], rtol=1e-4, atol=1e-8)


@pytest.mark.parametrize("name", sorted(MAILBOX))
def test_mailbox_transport_parity(world, name):
    """The cuda-ipc transport's mailbox collectives (member-order sums,
    the shard gathers, the ppermute hop's point-to-point reads) hold as
    the gloo world does: against the reference's round, and
    within 1e-5 relative of the gloo twin (the sums' order differs); the
    two hops bit-equal on the mailboxes too."""
    twin = MAILBOX[name]
    got, ref = world[name], world[twin]
    if twin in world["refs"]:
        _hold_round(got, PARITY[twin], world["refs"][twin])
    for k in ("params",):
        assert rel_err(got["state"][k], ref["state"][k]) <= REL
    for k, v in ref["state"]["opt"].items():
        if k != "count":
            assert rel_err(got["state"]["opt"][k], v) <= REL, k
    if name == "mailbox-hop-allgather":
        np.testing.assert_array_equal(
            got["state"]["params"],
            world["mailbox-sgd-ring-int8"]["state"]["params"])
