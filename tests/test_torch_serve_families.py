"""The port's serve engine on the moe, hybrid and ssm families against the
reference's: pool geometry (``geom_for``) and the recurrent-state layout
integer for integer, at the reductions and the published widths; the
state rows' round trip with trash masking; greedy tokens equal to the
reference engine's on the reductions under both policies (with the
reference's params from ``PRNGKey(0)``), and equal when each request is
replayed alone; the handoff of a packed round's checkpoint to the serve
params for zamba2's shared attention and xlstm's nested stacks; and both
launchers at ``--arch granite-moe-1b-a400m --reduced --device cpu``
(their ``main``, in this process).

Tolerance: none. Geometry, layouts, pool rows and greedy tokens are
exact; restored params are bit-equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jckpt
from repro.configs.base import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import decode as jdecode
from repro.serve import paging as jpaging
from repro.serve import restore_params as jrestore_params
from repro_torch import bridge, optim, tree
from repro_torch.checkpoint import io as ckpt
from repro_torch.configs.base import get_config
from repro_torch.core import localsgd as lsgd
from repro_torch.models.api import build_model
from repro_torch.optim import packing
from repro_torch.serve import (Engine, EngineConfig, Request, paging,
                               poisson_workload, restore_params)
from repro_torch.serve import decode as sdecode

ARCHS = ("granite-moe-1b-a400m", "zamba2-7b", "xlstm-1.3b")
ECFG = dict(n_slots=3, page_size=4, max_prompt=12, max_new=6)


def _layout_key(layout):
    return (layout.shapes, layout.offsets, layout.sizes, layout.size)


def _reference_paths(layout):
    """The reference layout's leaf paths, in its order."""
    numbered = jax.tree_util.tree_unflatten(
        layout.treedef, list(range(len(layout.shapes))))
    paths, leaves = tree.flatten(numbered)
    assert leaves == list(range(len(leaves)))
    return tuple(paths)


@pytest.mark.parametrize("arch", ARCHS + ("phi3.5-moe-42b-a6.6b",))
@pytest.mark.parametrize("reduced", [True, False])
def test_geometry_and_state_layout_equal_reference(arch, reduced):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jmodel, tmodel = jbuild_model(jcfg), build_model(tcfg)
    for kw in (dict(n_slots=3, page_size=4, max_len=20),
               dict(n_slots=8, page_size=16, max_len=144, slack_slots=1)):
        assert dataclasses.asdict(sdecode.geom_for(tmodel, **kw)) == \
            dataclasses.asdict(jdecode.geom_for(jmodel, **kw))
    got, want = sdecode.state_layout_for(tmodel), \
        jdecode.state_layout_for(jmodel)
    assert (got is None) == (want is None) == (tcfg.family == "moe")
    if got is not None:
        assert _layout_key(got) == _layout_key(want)
        assert got.paths == _reference_paths(want)
        assert [str(d).split(".")[-1] for d in got.dtypes] == \
            [str(d) for d in want.dtypes]


def test_state_rows_round_trip_and_trash_masking_equal_reference():
    """Two slots' packed states split into pool rows: read back exactly,
    and with one slot masked its rows stay untouched and its tiles land
    on the trash row; every row but the trash row equals the
    reference's pool."""
    g = paging.make_geom(page_size=2, n_kv=1, head_dim=4, n_layers_kv=0,
                         max_len=4, state_size=300, n_slots=2)
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((g.n_pages, g.page_elems)).astype(np.float32)
    rows = (1 + rng.permutation(g.n_pages - 1)[:2 * g.state_rows]).reshape(
        2, g.state_rows).astype(np.int32)
    buf = rng.standard_normal((2, 300)).astype(np.float32)
    for valid in (None, np.array([False, True])):
        want = np.asarray(jpaging.write_state(
            jnp.asarray(pool), jnp.asarray(rows), jnp.asarray(buf),
            valid=None if valid is None else jnp.asarray(valid)))
        got = torch.from_numpy(pool.copy())
        paging.write_state(got, torch.from_numpy(rows), torch.from_numpy(buf),
                           None if valid is None else torch.from_numpy(valid))
        np.testing.assert_array_equal(got.numpy()[1:], want[1:])
        back = paging.read_state(got, torch.from_numpy(rows), 300).numpy()
        np.testing.assert_array_equal(
            back, np.asarray(jpaging.read_state(jnp.asarray(want),
                                                jnp.asarray(rows), 300)))
        if valid is None:
            np.testing.assert_array_equal(back, buf)
        else:
            np.testing.assert_array_equal(got.numpy()[rows[0]], pool[rows[0]])
            np.testing.assert_array_equal(back[1], buf[1])
            assert not np.array_equal(got.numpy()[0], pool[0])


@pytest.fixture(scope="module", params=ARCHS)
def both(request):
    jcfg = jget_config(request.param).reduced()
    tcfg = get_config(request.param).reduced()
    jmodel, tmodel = jbuild_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.device_get(jparams))
    return jcfg, jmodel, jparams, tcfg, tmodel, tparams


def _reqs(cfg, n=5, seed=0):
    return poisson_workload(rate=20.0, n=n, seed=seed, prompt_len=(2, 12),
                            max_new=(2, 6), vocab=cfg.vocab_size)


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_engine_tokens_equal_reference(both, policy):
    """3 slots over 5 requests (queueing and slot reuse): the same greedy
    tokens in both engines, integer for integer."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = both
    reqs = _reqs(tcfg)
    got = Engine(tmodel, tparams, EngineConfig(policy=policy, **ECFG)).run(
        [Request(r.rid, r.prompt.copy(), r.max_new) for r in reqs])
    want = JEngine(jmodel, jparams, JEngineConfig(policy=policy, **ECFG)).run(
        [JRequest(r.rid, r.prompt.copy(), r.max_new) for r in reqs])
    got = {c.rid: c.tokens for c in got}
    assert got == {c.rid: c.tokens for c in want}
    for r in reqs:
        assert len(got[r.rid]) == min(r.max_new, ECFG["max_new"])


def test_continuous_equals_isolated_and_frees_every_row(both):
    _, _, _, tcfg, tmodel, tparams = both
    reqs = _reqs(tcfg, n=4, seed=1)
    eng = Engine(tmodel, tparams, EngineConfig(**ECFG))
    cont = {c.rid: c.tokens for c in eng.run(
        [Request(r.rid, r.prompt.copy(), r.max_new) for r in reqs])}
    for r in reqs:
        done = eng.run([Request(r.rid, r.prompt.copy(), r.max_new)])
        assert done[0].tokens == cont[r.rid], r.rid
    assert eng.free.available() == eng.geom.n_pages - 1


def test_prefill_equals_stepwise_decode(both):
    """The recurrent prefill is the step's token core run over the prompt:
    its first token and pool equal prefilling the prompt's first token
    and feeding the rest through ``step`` one at a time (moe: the
    batched prefill against the step, the same greedy token)."""
    _, _, _, tcfg, tmodel, tparams = both
    geom = sdecode.geom_for(tmodel, n_slots=1, page_size=4, max_len=16)
    progs = sdecode.build_programs(tmodel, geom, impl="torch")
    prompt = np.random.default_rng(3).integers(0, tcfg.vocab_size, 7)
    rows = paging.FreeList(geom.n_pages).alloc(geom.rows_per_slot)
    nk = geom.n_layers_kv * geom.max_blocks
    rk = rows[:nk].reshape(geom.n_layers_kv, geom.max_blocks)
    rv = rows[nk:2 * nk].reshape(geom.n_layers_kv, geom.max_blocks)
    sr = rows[2 * nk:]
    toks = np.zeros((1, 8), np.int32)
    toks[0, :7] = prompt
    tok_a, pool_a = progs.prefill(tparams, geom.pool(), toks, 7, rk, rv, sr)
    first = np.zeros((1, 8), np.int32)
    first[0, 0] = prompt[0]
    _, pool_b = progs.prefill(tparams, geom.pool(), first, 1, rk, rv, sr)
    for t in range(1, 7):
        tok_b, pool_b = progs.step(tparams, pool_b, prompt[t:t + 1],
                                   np.array([t], np.int32), rk[None],
                                   rv[None], np.ones(1, bool), sr[None])
    assert int(tok_a[0]) == int(tok_b[0])
    if tcfg.family != "moe":
        assert torch.equal(pool_a, pool_b)


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b"])
def test_packed_round_checkpoint_restores_to_serve_params(arch, tmp_path):
    """A (G, N) buffer after one packed round of the port, saved as the
    train launcher's packed checkpoint: the port and the reference
    restore the same serve params from it (the hybrid's shared_attn and
    the xlstm's nested (n_groups, n_m) stacks included), and the port's
    pytree checkpoint of them loads in the reference."""
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jmodel, tmodel = jbuild_model(jcfg), build_model(tcfg)
    params = tmodel.init(torch.Generator().manual_seed(0))
    layout = packing.layout_of(params)
    opt = optim.get("sgd", 0.05, packed=True)
    state = lsgd.init_state(params, opt, 2, layout)
    rnd = lsgd.make_local_round(tmodel.loss, opt,
                                lsgd.LocalSGDConfig(n_groups=2, inner_steps=1),
                                layout=layout)
    toks = torch.randint(0, tcfg.vocab_size, (2, 1, 16),
                         generator=torch.Generator().manual_seed(1))
    state, _ = rnd(state, {"tokens": toks})
    path = str(tmp_path / "packed")
    ckpt.save(path, {"buf": state["params"]}, metadata={"arch": tcfg.name})
    got = restore_params(path, tmodel, device="cpu")
    want = jax.device_get(jrestore_params(path, jmodel))
    paths, leaves = tree.flatten(got)
    jflat = dict(zip(paths, tree.leaves(want)))
    assert set(paths) == set(jflat)
    for p, leaf in zip(paths, leaves):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jflat[p]))
    server = lsgd.server_params(state, layout)
    for a, b in zip(tree.leaves(server), leaves):
        assert torch.equal(a, b)
    ckpt.save(path, got, metadata={"arch": tcfg.name})
    back = jax.device_get(jckpt.load(path, jmodel.abstract()))
    for a, b in zip(leaves, tree.leaves(back)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_launchers_train_and_serve_a_reduced_moe_on_cpu(tmp_path, capsys):
    """The train and serve launchers' ``main``, in this process: a packed
    moe run checkpointed, then served from it with the parity check."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher

    def run(main, args):
        # one intra-op thread: many small ops, whose parallel regions
        # stall when the machine is loaded (as under the parallel suite)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            main(args)
            code = 0
        except SystemExit as e:
            code = e.code
        finally:
            torch.set_num_threads(threads)
        out = capsys.readouterr()
        return code, out.out, out.err

    path = str(tmp_path / "moe")
    base = ["--arch", "granite-moe-1b-a400m", "--reduced", "--device", "cpu"]
    code, out, err = run(train_launcher.main, [
        *base, "--packed", "--rounds", "2", "--groups", "2", "--t-inner",
        "2", "--seq", "32", "--checkpoint", path])
    assert code == 0, err
    rounds = [l for l in out.splitlines() if l.startswith("round ")]
    assert len(rounds) == 2 and f"checkpoint -> {path}.npz" in out
    code, out, err = run(serve_launcher.main, [
        *base, "--from-checkpoint", path, "--requests", "4",
        "--check-parity"])
    assert code == 0, err
    assert "arch=granite-moe-1b-a400m-reduced" in out
    assert "parity OK: 4 requests identical" in out
