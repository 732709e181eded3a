"""The reference's own sharded packed round (shard_map on a (data 4,
model 2) mesh of forced host devices) for ``tests/test_torch_shardexec.py``:
server fp32 adamw, T 3, traj metrics, 3 rounds, on the cells' problem.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_ref_sharded_round.py out.npz
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from _torch_shard_cells import G, problem
from repro import comm, optim
from repro.core import localsgd as lsgd
from repro.optim import packing
from repro.sharding import shardexec as shx


def quad_loss(params, batch):
    r = batch["A"] @ params["w"] - batch["b"]
    return 0.5 * jnp.sum(r ** 2) + 0.1 * jnp.sum(params["u"] ** 2)


def main(out):
    assert jax.device_count() >= 8, jax.devices()
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
    sexec = shx.plan_for(mesh)
    params, batch = problem()
    params = jax.tree.map(jnp.asarray, params)
    layout = packing.shard_layout(packing.layout_of(params), sexec.n_shards)
    ex = comm.get_exchange("server", "fp32", G, mix_rounds=2, impl="jnp")
    opt = optim.get("adamw", 0.05, packed=True, impl="pallas")
    cfg = lsgd.LocalSGDConfig(n_groups=G, inner_steps=3, metrics="traj")
    rnd = jax.jit(lsgd.make_local_round(quad_loss, opt, cfg, layout=layout,
                                        exchange=ex, shardexec=sexec))
    st = lsgd.init_state(params, opt, n_groups=G, layout=layout, exchange=ex)
    jb = jax.tree.map(jnp.asarray, batch)
    for _ in range(3):
        st, m = rnd(st, jb)
    np.savez(out, params=np.asarray(st["params"]), m=np.asarray(st["opt"]["m"]),
             v=np.asarray(st["opt"]["v"]),
             grad_sq_traj=np.asarray(m["grad_sq_traj"]))


if __name__ == "__main__":
    main(sys.argv[1])
