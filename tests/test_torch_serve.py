"""The port's serve path against the reference's on the same params and
workload: pool geometry and FreeList, the two KV writes, greedy tokens of
the engine under both policies, continuous against isolated, the
1024-token prefill through the flash kernel's plain version,
backpressure and refusals, the checkpoint handoff in both directions, and
the step trace under the reference's ``obs.report`` check.

Tolerance: greedy tokens, geometry, allocations and page writes are
exact; prefill logits rtol 1e-4 / atol 1e-5 (float32 through two
layers, products and reductions summed in another order by XLA and
PyTorch, and the reference's blocked softmax against the port's
flash softmax)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jckpt
from repro.configs.base import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.obs import report
from repro.optim.packing import layout_of as jlayout_of
from repro.optim.packing import pack as jpack
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import decode as jdecode
from repro.serve import paging as jpaging
from repro.serve import poisson_workload as jpoisson_workload
from repro.serve import restore_params as jrestore_params
from repro_torch import bridge, tree
from repro_torch.checkpoint import io as ckpt
from repro_torch.configs.base import get_config
from repro_torch.models.api import build_model
from repro_torch.obs.trace import Trace
from repro_torch.serve import (Engine, EngineConfig, Request, drive_workload,
                               paging, poisson_workload, restore_params)
from repro_torch.serve import decode as sdecode

LOGITS_TOL = dict(rtol=1e-4, atol=1e-5)
ECFG = dict(page_size=4, max_prompt=12, max_new=8)


@pytest.fixture(scope="module")
def both():
    """paper-mlp reduced (GQA, n_kv 2 of 4 heads) in both packages, on the
    reference's params."""
    jcfg = jget_config("paper-mlp").reduced()
    tcfg = get_config("paper-mlp").reduced()
    jmodel, tmodel = jbuild_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.device_get(jparams))
    return jcfg, jmodel, jparams, tcfg, tmodel, tparams


def _reqs(cfg, n=6, seed=0):
    return poisson_workload(rate=20.0, n=n, seed=seed, prompt_len=(2, 12),
                            max_new=(2, 8), vocab=cfg.vocab_size)


def _tokens(done):
    return {c.rid: c.tokens for c in done}


def _jrun(jmodel, jparams, reqs, **ecfg):
    eng = JEngine(jmodel, jparams, JEngineConfig(**ecfg))
    return _tokens(eng.run([JRequest(r.rid, r.prompt.copy(), r.max_new)
                            for r in reqs]))


def _run(tmodel, tparams, reqs, **ecfg):
    eng = Engine(tmodel, tparams, EngineConfig(**ecfg))
    return _tokens(eng.run([Request(r.rid, r.prompt.copy(), r.max_new)
                            for r in reqs]))


# -- geometry, FreeList, page writes ------------------------------------


@pytest.mark.parametrize("kw", [
    dict(page_size=4, n_kv=2, head_dim=16, n_layers_kv=3, max_len=10,
         state_size=0, n_slots=2),
    dict(page_size=16, n_kv=12, head_dim=64, n_layers_kv=8, max_len=1056,
         state_size=0, n_slots=8),
    dict(page_size=8, n_kv=1, head_dim=8, n_layers_kv=2, max_len=20,
         state_size=0, n_slots=3, slack_slots=1),
])
def test_geometry_equals_reference(kw):
    got = dataclasses.asdict(paging.make_geom(**kw))
    assert got == dataclasses.asdict(jpaging.make_geom(**kw))
    g = paging.make_geom(**kw)
    assert g.page_elems % paging.ALIGN == 0
    assert g.pool().shape == (g.n_pages, g.page_elems)


def test_paper_lenet_serve_geometry():
    """The chip smoke's engine: bucket 1024 + 32 new tokens in pages of
    16 -> 66 blocks, 12,288-float rows, 8,449 rows (a 415 MB pool)."""
    model = build_model(get_config("paper-lenet"))
    g = sdecode.geom_for(model, n_slots=8, page_size=16, max_len=1056)
    assert (g.max_blocks, g.page_elems, g.n_pages) == (66, 12_288, 8_449)
    assert g.n_pages * g.page_elems * 4 == 415_285_248


def test_geom_for_equals_reference(both):
    _, jmodel, _, _, tmodel, _ = both
    for kw in (dict(n_slots=3, page_size=4, max_len=20),
               dict(n_slots=1, page_size=8, max_len=8, n_pages=40)):
        assert dataclasses.asdict(sdecode.geom_for(tmodel, **kw)) == \
            dataclasses.asdict(jdecode.geom_for(jmodel, **kw))


def test_freelist_equals_reference_and_never_hands_out_trash():
    """The same allocations and frees give the same rows in both
    packages; row 0 is never handed out and cannot be freed."""
    a, b = paging.FreeList(9), jpaging.FreeList(9)
    held = []
    for op, n in (("alloc", 3), ("alloc", 2), ("free", 0), ("alloc", 4),
                  ("alloc", 3), ("free", 0), ("alloc", 5), ("alloc", 1)):
        if op == "free":
            x, y = held.pop(n)
            a.free(x)
            b.free(y)
        else:
            x, y = a.alloc(n), b.alloc(n)
            assert (x is None) == (y is None), (op, n)
            if x is not None:
                assert x.tolist() == y.tolist()
                assert paging.TRASH_ROW not in x.tolist()
                held.append((x, y))
        assert a.available() == b.available()
    assert a.alloc(a.available() + 1) is None        # backpressure
    with pytest.raises(ValueError, match="trash"):
        a.free(np.array([0], np.int32))


def test_token_kv_write_equals_reference():
    """Three active slots and two inactive ones (routed to the trash
    row): every row but the trash row equals the reference's pool, and
    the trash row is the only one the inactive slots touch."""
    g = jpaging.make_geom(page_size=4, n_kv=2, head_dim=8, n_layers_kv=1,
                          max_len=12, state_size=0, n_slots=5)
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((g.n_pages, g.page_elems)).astype(np.float32)
    rows = (1 + rng.permutation(g.n_pages - 1)[:15]).reshape(5, 3)
    rows = rows.astype(np.int32)
    blk = np.array([0, 2, 1, 0, 2], np.int32)
    off = np.array([3, 0, 2, 1, 3], np.int32)
    vec = rng.standard_normal((5, 16)).astype(np.float32)
    valid = np.array([True, False, True, True, False])
    want = np.asarray(jpaging.write_token_kv(
        jnp.asarray(pool), jnp.asarray(rows), jnp.asarray(blk),
        jnp.asarray(off), jnp.asarray(vec), valid=jnp.asarray(valid)))
    got = torch.from_numpy(pool.copy())
    paging.write_token_kv(got, torch.from_numpy(rows), torch.from_numpy(blk),
                          torch.from_numpy(off), torch.from_numpy(vec),
                          torch.from_numpy(valid))
    got = got.numpy()
    np.testing.assert_array_equal(got[1:], want[1:])
    changed = np.flatnonzero((got != pool).any(axis=1))
    assert set(changed) == {0} | {rows[i, blk[i]] for i in (0, 2, 3)}
    assert not np.isin(rows, [paging.TRASH_ROW]).any()


def test_prefill_kv_write_equals_reference():
    rng = np.random.default_rng(1)
    pool = rng.standard_normal((9, 256)).astype(np.float32)
    rows = np.array([4, 7, 2], np.int32)
    mat = rng.standard_normal((3, 200)).astype(np.float32)
    want = np.asarray(jpaging.write_prefill_kv(
        jnp.asarray(pool), jnp.asarray(rows), jnp.asarray(mat)))
    got = torch.from_numpy(pool.copy())
    paging.write_prefill_kv(got, torch.from_numpy(rows), torch.from_numpy(mat))
    np.testing.assert_array_equal(got.numpy(), want)


# -- the engine ----------------------------------------------------------


def test_poisson_workload_equals_reference():
    a = poisson_workload(rate=4.0, n=5, seed=3, prompt_len=(2, 9),
                         max_new=(1, 6), vocab=1024)
    b = jpoisson_workload(rate=4.0, n=5, seed=3, prompt_len=(2, 9),
                          max_new=(1, 6), vocab=1024)
    for x, y in zip(a, b):
        assert (x.rid, x.max_new, x.arrival) == (y.rid, y.max_new, y.arrival)
        np.testing.assert_array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_engine_tokens_equal_reference(both, policy):
    """The same workload through both engines (3 slots over 6 requests:
    queueing and slot reuse) gives the same greedy tokens."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = both
    reqs = _reqs(tcfg)
    got = _run(tmodel, tparams, reqs, n_slots=3, policy=policy, **ECFG)
    want = _jrun(jmodel, jparams, reqs, n_slots=3, policy=policy, **ECFG)
    assert got == want
    by_rid = {r.rid: r for r in reqs}
    for rid, toks in got.items():
        assert len(toks) == min(by_rid[rid].max_new, ECFG["max_new"])
        assert all(0 <= t < tcfg.vocab_size for t in toks)


def test_continuous_equals_isolated(both):
    """Each request replayed alone, at the same slot count, gives the
    tokens it got in the continuous run."""
    _, _, _, tcfg, tmodel, tparams = both
    reqs = _reqs(tcfg, n=5, seed=1)
    cont = _run(tmodel, tparams, reqs, n_slots=3, **ECFG)
    eng = Engine(tmodel, tparams, EngineConfig(n_slots=3, **ECFG))
    for r in reqs:
        done = eng.run([Request(r.rid, r.prompt.copy(), r.max_new)])
        assert done[0].tokens == cont[r.rid], r.rid
    assert eng.free.available() == eng.geom.n_pages - 1


def test_prefill_through_flash_matches_reference_blocked(both):
    """A 1024-token bucket with attn_impl="pallas" runs the prefill
    through the flash kernel's plain version (its condition: two
    512-blocks); the reference's blocked path on the same prompt gives
    the same first token and logits, and the engines the same tokens."""
    jcfg, jmodel, jparams, tcfg, _, tparams = both
    tmodel = build_model(dataclasses.replace(tcfg, attn_impl="pallas"))
    geom = sdecode.geom_for(tmodel, n_slots=1, page_size=16, max_len=1028)
    progs = sdecode.build_programs(tmodel, geom)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, tcfg.vocab_size, size=700).astype(np.int32)
    toks = np.zeros((1, 1024), np.int32)
    toks[0, :700] = prompt
    rows = paging.FreeList(geom.n_pages).alloc(geom.rows_per_slot)
    nk = geom.n_layers_kv * geom.max_blocks
    rk = rows[:nk].reshape(geom.n_layers_kv, -1)
    rv = rows[nk:].reshape(geom.n_layers_kv, -1)
    from repro_torch.kernels import flash_attention as fa
    before = fa.launches
    logits, _ = progs.prefill_logits(tparams, geom.pool(), toks, 700, rk, rv)
    assert fa.launches == before             # the CPU takes the plain version
    x, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    head = jparams["lm_head"]
    want = np.asarray(x[0, 699] @ head)[None]
    np.testing.assert_allclose(logits.numpy(), want, **LOGITS_TOL)
    assert int(logits[0, :tcfg.vocab_size].argmax()) == \
        int(want[0, :jcfg.vocab_size].argmax())
    reqs = poisson_workload(rate=20.0, n=2, seed=5, prompt_len=(600, 1024),
                            max_new=(2, 4), vocab=tcfg.vocab_size)
    ecfg = dict(n_slots=2, page_size=16, max_prompt=1024, max_new=4)
    assert _run(tmodel, tparams, reqs, **ecfg) == \
        _jrun(jmodel, jparams, reqs, **ecfg)


def test_backpressure_defers_then_completes(both):
    _, _, _, tcfg, tmodel, tparams = both
    probe = sdecode.geom_for(tmodel, n_slots=2, page_size=4, max_len=16)
    tight = 1 + probe.rows_per_slot     # the pool fits exactly ONE request
    path_reqs = _reqs(tcfg, n=4, seed=2)
    eng = Engine(tmodel, tparams, EngineConfig(
        n_slots=2, page_size=4, max_prompt=8, max_new=8, n_pages=tight))
    for r in path_reqs:
        r.prompt = r.prompt[:8]
    done = eng.run([Request(r.rid, r.prompt.copy(), r.max_new)
                    for r in path_reqs])
    assert {c.rid for c in done} == {r.rid for r in path_reqs}
    assert eng.deferred_total > 0
    starved = Engine(tmodel, tparams, EngineConfig(
        n_slots=1, page_size=4, max_prompt=8, max_new=8, n_pages=2))
    starved.submit(Request(0, np.zeros(1, np.int32), 2))
    with pytest.raises(RuntimeError, match="pool too small"):
        starved.step()


def test_refusals(both):
    _, _, _, tcfg, tmodel, tparams = both
    for fam in ("vlm", "audio"):
        model = dataclasses.replace(tmodel,
                                    cfg=dataclasses.replace(tcfg, family=fam))
        with pytest.raises(NotImplementedError, match="modality"):
            sdecode.geom_for(model, n_slots=1, page_size=4, max_len=8)
    geom = sdecode.geom_for(tmodel, n_slots=1, page_size=4, max_len=8)
    with pytest.raises(ValueError, match="unknown impl"):
        sdecode.build_programs(tmodel, geom, impl="pallas")
    eng = Engine(tmodel, tparams, EngineConfig(n_slots=1, impl="cuda", **ECFG))
    with pytest.raises(ValueError, match="impl='cuda'"):
        eng.run([Request(0, np.ones(3, np.int32), 2)])
    with pytest.raises(ValueError, match="bucket"):
        Engine(tmodel, tparams, EngineConfig(n_slots=1, **ECFG)).submit(
            Request(0, np.ones(13, np.int32), 2))


# -- checkpoint handoff --------------------------------------------------


def _assert_params_equal(tparams, jtree):
    paths, leaves = tree.flatten(tparams)
    jflat = {"/".join(p): np.asarray(v) for p, v in zip(
        paths, tree.leaves(jax.device_get(jtree)))}
    for p, leaf in zip(paths, leaves):
        np.testing.assert_array_equal(leaf.numpy(), jflat["/".join(p)])


def test_handoff_reference_checkpoint_pytree_and_packed(both, tmp_path):
    """Both formats restore to the reference's own restore_params result
    (the (G, size) buffer's groups averaged the same way)."""
    jcfg, jmodel, jparams, _, tmodel, _ = both
    path = str(tmp_path / "ref_pytree")
    jckpt.save(path, jparams, metadata={"arch": jcfg.name, "rounds": 3})
    got = restore_params(path, tmodel, device="cpu")
    _assert_params_equal(got, jparams)

    buf = np.asarray(jpack(jparams, jlayout_of(jparams)))
    path = str(tmp_path / "ref_packed")
    jckpt.save(path, {"buf": np.stack([buf, buf + 1.0])},
               metadata={"arch": jcfg.name})
    got = restore_params(path, tmodel, device="cpu")
    _assert_params_equal(got, jrestore_params(path, jmodel))


def test_handoff_port_checkpoint_loads_in_reference(both, tmp_path):
    """A port checkpoint (float32 and a bfloat16 leaf) loads through the
    reference's checkpoint.io.load, and back through the port's."""
    _, jmodel, jparams, tcfg, _, tparams = both
    path = str(tmp_path / "port")
    ckpt.save(path, tparams, metadata={"arch": tcfg.name})
    _assert_params_equal(tparams, jckpt.load(path, jmodel.abstract()))
    assert jckpt.load_metadata(path) == {"arch": tcfg.name}
    half = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)
            .to(torch.bfloat16), "n": torch.ones(2)}
    ckpt.save(path, half)
    back = jckpt.load(path, {"w": 0, "n": 0})
    assert back["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["w"], np.float32),
                                  half["w"].float().numpy())
    again = ckpt.load(path, half)
    assert again["w"].dtype == torch.bfloat16 and torch.equal(again["w"],
                                                              half["w"])


def test_handoff_refuses_wrong_arch_and_format(both, tmp_path):
    _, _, _, tcfg, tmodel, tparams = both
    path = str(tmp_path / "other")
    ckpt.save(path, tparams, metadata={"arch": "paper-lenet"})
    with pytest.raises(ValueError, match="trained for arch"):
        restore_params(path, tmodel, device="cpu")
    restore_params(path, tmodel, check_arch=False, device="cpu")
    ckpt.save(path, {"w": torch.ones(3)}, metadata={"arch": tcfg.name})
    with pytest.raises(ValueError, match="neither"):
        restore_params(path, tmodel, device="cpu")
    ckpt.save(path, {"buf": torch.ones(10)}, metadata={"arch": tcfg.name})
    with pytest.raises(ValueError, match="wrong config"):
        restore_params(path, tmodel, device="cpu")


# -- trace ---------------------------------------------------------------


def test_serve_trace_passes_reference_report_check(both, tmp_path):
    _, _, _, tcfg, tmodel, tparams = both
    path = tmp_path / "serve.jsonl"
    trace = Trace(str(path), meta={"launcher": "serve", "arch": tcfg.name})
    eng = Engine(tmodel, tparams, EngineConfig(n_slots=2, **ECFG),
                 trace=trace)
    done, makespan = drive_workload(eng, _reqs(tcfg, n=4, seed=6))
    trace.close()
    assert len(done) == 4 and makespan > 0
    meta, records = report.load(path)
    assert report.check(meta, records) == []
    steps = report.steps_of(records)
    assert len(steps) == eng.step_idx
    assert all("decode_step" in s["phase_s"] or s["metrics"]["admitted"]
               for s in steps)
    s = report.summarize(meta, records)
    assert "prefill" in s["phase_s"] and "decode_step" in s["phase_s"]
    assert s["serve"]["deferred_total"] == 0
