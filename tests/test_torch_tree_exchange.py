"""The pytree round's exchange in the port against the JAX package's pytree
round, on the same numpy inputs: the cast codecs (fp16, bf16) on the
params, moment and downlink streams, async_stale, the faulty server, ring
and gossip, push_sum and the two tiers, each stream a tree run leaf by
leaf (the reference's ``repro/comm/exchange.py`` ``streams`` under
``jax.tree.map``).

Model: the (r=24, d=32) least-squares quadratic of
``tests/test_torch_pytree_round.py``, its params split into two leaves of
other shapes ({"u": (8,), "v": (4, 6)}), G 4 (8 where a topology needs
it), 3 rounds; and the paper-mlp reduction of that file for one adamw
case (its tolerances, ``MODEL_TOL``, adamw's params at atol 1e-5).

Tolerances, with their reasons:
- fp32 streams: ``TOL`` (rtol 1e-5, atol 1e-6), as in
  ``test_torch_pytree_round.py``: a few dozen float32 steps whose sums
  run in another order.
- a run with an fp16 or bf16 codec on any stream: one ulp of the codec at
  the values' magnitude (``codec_tol``: rtol and, over the largest |value|
  of the compared array, atol of 2**-10 for fp16, 2**-7 for bf16). A
  float32 difference in the last bit can move a cast to the neighbouring
  codec value, as ``tests/test_torch_faults.py`` and
  ``test_torch_push_sum.py`` state.
- exact: the fault masks' effects (participation, overall and per tier),
  the round counters, the inner step counts, the wire bytes, the metric
  key sets and the comm state's tree structure (keys, shapes, dtypes).
  The participation scalars are held exactly against the reference's
  exchange run eagerly over the same rounds (they depend on the round's
  masks alone); the jitted reference round's own scalars differ from its
  eager ones by at most one float32 ulp (XLA's division of the summed
  masks), and are held to that.
- push-sum's mass and queued weight at rtol 1e-6, as in
  ``test_torch_push_sum.py``; a comm-state leaf (a backlog's residue, a
  staleness buffer, a downlink reference) at its stream's tolerance, at
  the magnitude of its stream's values.

The pytree round is also held against the port's own packed round with
the same exchange (same tolerances), and against itself: it launches no
kernel, leaves its caller's state as it was, and advances push-sum's
weight channel once a round however many leaves a stream has.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro import optim as joptim
from repro.configs.base import get_config as jax_get_config
from repro.core import localsgd as jlsgd
from repro.data.synthetic import TokenPipeline as JaxTokenPipeline
from repro.models import build_model as jax_build_model
from repro_torch import bridge, comm, optim, tree
from repro_torch.comm import exchange as exchange_mod
from repro_torch.configs.base import get_config
from repro_torch.core import localsgd as lsgd
from repro_torch.models.api import build_model
from repro_torch.optim import packing

R, D, ROUNDS = 24, 32, 3
TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=2e-4, atol=1e-6)
CODEC_ULP = {"fp16": 2.0 ** -10, "bf16": 2.0 ** -7}
MASS_TOL = dict(rtol=1e-6, atol=1e-7)
PART_KEYS = ("participation", "participation_intra", "participation_inter")
EXACT_METRICS = ("inner_steps", "delivery_rate", "delivery_rate_intra",
                 "delivery_rate_inter")


def loss_j(params, batch):
    w = jnp.concatenate([params["u"], params["v"].reshape(-1)])
    r = batch["A"] @ w - batch["b"]
    return 0.5 * jnp.sum(r ** 2)


def loss_t(params, batch):
    w = torch.cat([params["u"], params["v"].reshape(-1)])
    r = batch["A"] @ w - batch["b"]
    return 0.5 * torch.sum(r ** 2)


def problem(seed, g, micro_t=None):
    """(params, batch) as numpy float32: each group's (A, b) shares the
    solution w*; the params are w0 split into two leaves of other
    shapes; with ``micro_t`` the batch has a (G, T) microbatch axis."""
    rng = np.random.RandomState(seed)
    lead = (g,) if micro_t is None else (g, micro_t)
    A = (rng.randn(*lead, R, D) / np.sqrt(D)).astype(np.float32)
    w_star = rng.randn(D).astype(np.float32)
    b = np.einsum("...rd,d->...r", A, w_star).astype(np.float32)
    w0 = rng.randn(D).astype(np.float32)
    return {"u": w0[:8], "v": w0[8:].reshape(4, 6)}, {"A": A, "b": b}


@dataclasses.dataclass(frozen=True)
class Case:
    opt: str
    lr: float
    ex: dict                       # get_exchange's keywords
    g: int = 4
    cfg: dict = dataclasses.field(default_factory=dict)   # LocalSGDConfig
    seed: int = 1

    @property
    def micro_t(self):
        return (self.cfg.get("inner_steps")
                if self.cfg.get("inner_mode") == "microbatch" else None)

    def local_cfg(self, pkg, **kw):
        return pkg.LocalSGDConfig(**{"n_groups": self.g, "inner_steps": 2,
                                     **self.cfg, **kw})

    def exchanges(self):
        kw = {"topology": "server", "n_groups": self.g, **self.ex}
        return jcomm.get_exchange(**kw), comm.get_exchange(**kw)

    @property
    def cast(self):
        """The cast codec on the run's wire, if any (its ulp sets the
        tolerance)."""
        names = [self.ex.get(k, "") for k in ("codec", "moment_codec",
                                              "downlink_codec",
                                              "inter_codec")]
        return next((n for n in names if n in CODEC_ULP), None)


CASES = {
    # the cast codecs on each stream, over every flat topology
    "server-bf16": Case("sgd", 0.1, dict(codec="bf16")),
    "server-fp16-momentum": Case("momentum", 0.05, dict(codec="fp16")),
    "ring-fp16-2hops": Case("sgd", 0.1, dict(topology="ring", codec="fp16",
                                             mix_rounds=2)),
    "gossip-bf16-g8": Case("momentum", 0.05, dict(topology="gossip",
                                                  codec="bf16"), g=8),
    "moment-bf16-adamw": Case("adamw", 0.02, dict(moment_codec="bf16")),
    "moment-fp16-ring": Case("momentum", 0.05, dict(
        topology="ring", codec="bf16", moment_codec="fp16")),
    "downlink-bf16": Case("momentum", 0.05, dict(downlink_codec="bf16")),
    "downlink-fp16-adamw": Case("adamw", 0.02, dict(
        codec="fp16", downlink_codec="fp16")),
    # async_stale, with and without the opt state averaged
    "async-adamw": Case("adamw", 0.02, dict(topology="async_stale",
                                            staleness=1)),
    "async-bf16-downlink": Case("momentum", 0.05, dict(
        topology="async_stale", codec="bf16", staleness=2,
        downlink_codec="fp16")),
    "async-no-opt-avg": Case("momentum", 0.05, dict(
        topology="async_stale", staleness=1),
        cfg=dict(average_opt_state=False)),
    # fault plans on the flat topologies
    "faulty-server-adamw": Case("adamw", 0.02, dict(drop_rate=0.3,
                                                    fault_seed=1)),
    "faulty-server-bf16": Case("sgd", 0.1, dict(
        codec="bf16", moment_codec="bf16", drop_rate=0.2, stall_rate=0.1,
        fault_seed=2)),
    "faulty-async": Case("momentum", 0.05, dict(
        topology="async_stale", staleness=1, drop_rate=0.25, fault_seed=2)),
    "faulty-ring": Case("sgd", 0.1, dict(topology="ring", mix_rounds=2,
                                         drop_rate=0.2, stall_rate=0.1,
                                         fault_seed=2)),
    "faulty-ring-fp16": Case("momentum", 0.05, dict(
        topology="ring", codec="fp16", drop_rate=0.2, fault_seed=5)),
    "faulty-gossip-g8": Case("momentum", 0.05, dict(
        topology="gossip", mix_rounds=2, drop_rate=0.2, stall_rate=0.1,
        moment_codec="bf16", fault_seed=3), g=8),
    # push_sum with drops and stalls
    "push_sum": Case("sgd", 0.1, dict(topology="push_sum", drop_rate=0.2,
                                      stall_rate=0.05, fault_seed=1)),
    "push_sum-2hops-bf16": Case("momentum", 0.05, dict(
        topology="push_sum", codec="bf16", moment_codec="fp16",
        mix_rounds=2, drop_rate=0.1, fault_seed=3)),
    "push_sum-dropout-adamw": Case("adamw", 0.02, dict(
        topology="push_sum", dropouts=((2, 1, 3),), fault_seed=0)),
    # the two tiers with intra and inter faults
    "hier-ring-push_sum": Case("sgd", 0.1, dict(
        topology="hierarchical", n_pods=4, drop_rate=0.2, stall_rate=0.05,
        intra_drop_rate=0.1, fault_seed=4), g=8),
    "hier-ring-fp16-adamw": Case("adamw", 0.02, dict(
        topology="hierarchical", codec="fp16", n_pods=2, mix_rounds=2,
        drop_rate=0.3, intra_stall_rate=0.2, fault_seed=1), g=8),
    "hier-server-server-bf16": Case("momentum", 0.05, dict(
        topology="hierarchical", n_pods=2, intra_topology="server",
        inter_topology="server", inter_codec="bf16",
        intra_drop_rate=0.2, fault_seed=2), g=8),
    "hier-server-push_sum": Case("momentum", 0.05, dict(
        topology="hierarchical", n_pods=4, intra_topology="server",
        inter_codec="bf16", drop_rate=0.3, fault_seed=6), g=8),
    # the modes with one faulty exchange
    "threshold-faulty-ring": Case("sgd", 0.1, dict(
        topology="ring", drop_rate=0.2, fault_seed=1),
        cfg=dict(inner_steps=1, threshold=1e-2, max_inner=60)),
    "t_i-push_sum": Case("adamw", 0.02, dict(
        topology="push_sum", drop_rate=0.2, fault_seed=2),
        cfg=dict(inner_steps=3, t_i=(0, 3, 1, 2))),
    "microbatch-faulty-server": Case("momentum", 0.05, dict(
        codec="fp16", drop_rate=0.2, fault_seed=3),
        cfg=dict(inner_steps=3, inner_mode="microbatch")),
}


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def structure(x):
    """A comm state's tree structure: keys, and each leaf's shape and
    dtype."""
    if isinstance(x, dict):
        return {k: structure(v) for k, v in x.items()}
    a = _np(x)
    return (a.shape, str(a.dtype))


def flat(x, path=()):
    """(path, numpy leaf) pairs of a nested dict."""
    if isinstance(x, dict):
        return [p for k in sorted(x) for p in flat(x[k], path + (k,))]
    return [(path, _np(x))]


def codec_tol(codec, want, scale=0.0):
    """One ulp of ``codec`` at the values' magnitude (the larger of
    ``want``'s and ``scale``), or TOL when no codec casts."""
    if codec is None:
        return TOL
    ulp = CODEC_ULP[codec]
    return dict(rtol=ulp, atol=ulp * max(float(np.abs(want).max(
        initial=0.0)), scale))


def assert_close(got, want, codec, what, tol=None, scale=0.0):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, err_msg=str(what),
                               **(tol or codec_tol(codec, want, scale)))


def assert_participation(got, want, eager, what):
    """Exactly the reference's eager scalar; within one float32 ulp of its
    jitted one."""
    got = np.asarray(got, np.float32)
    np.testing.assert_array_max_ulp(got, np.asarray(want, np.float32), 1)
    if eager is not None:
        np.testing.assert_array_equal(got, eager, err_msg=str(what))


def _stream_scale(jst, path):
    """The largest |value| of the stream a comm-state leaf belongs to (a
    backlog's residue is what is left of a cast of those values)."""
    names = ["params"] + [k for k in jst["opt"] if k != "count"]
    for k in ("params",) if path[0] == "pushed" else path:
        if k in names:
            v = jst["params"] if k == "params" else jst["opt"][k]
            return max(float(np.abs(x).max()) for _, x in flat(v))
    return 0.0


def assert_state(jst, tst, codec, part=None, tol=None):
    """params, opt and comm state: the comm state's structure exact, its
    counters exact, participation as ``assert_participation`` (``part``:
    the eager reference's scalars), mass at MASS_TOL, the rest as the
    streams."""
    assert structure(tst.get("comm", {})) == structure(jst.get("comm", {}))
    for sec in ("params", "opt", "comm"):
        for (tp, tv), (jp, jv) in zip(flat(tst.get(sec, {})),
                                      flat(jst.get(sec, {}))):
            assert tp == jp
            what = (sec,) + tp
            if tp[-1] in ("round", "count"):
                np.testing.assert_array_equal(tv, jv, err_msg=str(what))
            elif sec == "comm" and tp[0] in PART_KEYS:
                assert_participation(tv, jv, (part or {}).get(tp[0]), what)
            elif tp[0] in ("mass", "backlog_w"):
                np.testing.assert_allclose(tv, jv, err_msg=str(what),
                                           **MASS_TOL)
            else:
                assert_close(tv, jv, codec, what, tol,
                             _stream_scale(jst, tp)
                             if sec == "comm" and codec else 0.0)


def assert_metrics(jm, tm, codec, part=None, tol=None):
    """The key sets equal; wire bytes, inner steps and delivery rates
    exact; participation as ``assert_participation`` (``part``: the eager
    reference's comm-state scalars; the metrics mirror them, intra the
    overall one on a flat topology, 1.0 where absent)."""
    assert set(tm) == set(jm)
    if part is not None:
        part = dict(part)
        if "participation" in part:
            part.setdefault("participation_intra", part["participation"])
    for k, jv in jm.items():
        if k.startswith("wire_bytes") or k in EXACT_METRICS:
            np.testing.assert_array_equal(_np(tm[k]), np.asarray(jv),
                                          err_msg=k)
        elif k in PART_KEYS:
            assert_participation(_np(tm[k]), jv, None if part is None else
                                 part.get(k, np.float32(1.0)), k)
        else:
            assert_close(_np(tm[k]), jv, codec, k, tol)


def _clone(x):
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x.clone()


def ref_run(case):
    """The reference's jitted pytree round over ROUNDS rounds: (states,
    metrics), one each a round, on the host."""
    params, batch = problem(case.seed, case.g, case.micro_t)
    jex, _ = case.exchanges()
    opt = joptim.get(case.opt, case.lr)
    rnd = jax.jit(jlsgd.make_local_round(loss_j, opt, case.local_cfg(jlsgd),
                                         exchange=jex))
    st = jlsgd.init_state(jax.tree.map(jnp.asarray, params), opt,
                          n_groups=case.g, exchange=jex,
                          average_opt_state=case.local_cfg(
                              jlsgd).average_opt_state)
    jb = jax.tree.map(jnp.asarray, batch)
    states, ms = [], []
    for _ in range(ROUNDS):
        st, m = rnd(st, jb)
        states.append(jax.device_get(st))
        ms.append(jax.device_get(m))
    return states, ms


def port_run(case, packed=False):
    """The port's pytree (or packed) round over ROUNDS rounds: (states,
    metrics, exchange), the states copied out each round."""
    params, batch = problem(case.seed, case.g, case.micro_t)
    _, ex = case.exchanges()
    tp = bridge.params_from_numpy(params)
    layout = packing.layout_of(tp) if packed else None
    opt = optim.get(case.opt, case.lr, packed=packed)
    # the packed round's per-step metrics, as the pytree round records
    lcfg = case.local_cfg(lsgd, **({"metrics": "traj"} if packed else {}))
    rnd = lsgd.make_local_round(loss_t, opt, lcfg, layout=layout,
                                exchange=ex)
    st = lsgd.init_state(tp, opt, case.g, layout, exchange=ex,
                         average_opt_state=lcfg.average_opt_state)
    tb = bridge.params_from_numpy(batch)
    states, ms = [], []
    for _ in range(ROUNDS):
        st, m = rnd(st, tb)
        states.append(_clone(st))
        ms.append(m)
    return states, ms, ex


def ref_participation(case):
    """The reference's participation scalars a round, from its exchange
    run eagerly over ROUNDS rounds on zero streams: they depend on the
    round's fault masks alone. [{key: float32}] ({} where the state keeps
    none)."""
    jex, _ = case.exchanges()
    if not jex.stateful:
        return [{}] * ROUNDS
    zero = jnp.zeros((case.g, 2), jnp.float32)
    st, out = jex.init(zero), []
    for _ in range(ROUNDS):
        _, st = jex.streams({"params": zero}, {"params": zero}, st)
        out.append({k: np.asarray(st[k], np.float32) for k in PART_KEYS
                    if k in st})
    return out


@pytest.fixture(scope="module")
def runs():
    """The reference's runs (the jitted round, and the eager exchange's
    participation), each made once for the module's tests."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = (*ref_run(CASES[name]),
                           ref_participation(CASES[name]))
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(CASES))
def test_tree_exchange_matches_reference(runs, name):
    case = CASES[name]
    js, jms, parts = runs(name)
    ts, tms, ex = port_run(case)
    for jst, tst, jm, tm, part in zip(js, ts, jms, tms, parts):
        assert_state(jst, tst, case.cast, part)
        assert_metrics(jm, tm, case.cast, part)
    if "mass" in ts[-1].get("comm", {}):
        c = ts[-1]["comm"]
        assert float(c["mass"].sum() + c["backlog_w"].sum()) == \
            pytest.approx(case.g, abs=1e-3)
    if ex.faulty:       # the faults fired
        assert min(float(m["participation"]) for m in tms) < 1.0


def _packed_rows(tree_G, g):
    """A tree of (G, ...) leaves as the packed round's (G, N) buffer (the
    leaves in the layout's order; no pad at these sizes)."""
    return torch.cat([x.reshape(g, -1) for x in tree.leaves(tree_G)], 1)


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items()
                                        if "threshold" not in c.cfg))
def test_tree_round_matches_packed_round(name):
    """The port's pytree round against its packed round with the same
    exchange: the params and moment rows, the comm counters, the mass and
    every exact metric."""
    case = CASES[name]
    ts, tms, _ = port_run(case)
    ps, pms, _ = port_run(case, packed=True)
    for tst, pst, tm, pm in zip(ts, ps, tms, pms):
        assert_close(_packed_rows(tst["params"], case.g).numpy(),
                     pst["params"].numpy(), case.cast, "params")
        for k, v in tst["opt"].items():
            if k != "count":
                assert_close(_packed_rows(v, case.g).numpy(),
                             pst["opt"][k].numpy(), case.cast, k)
        for k in ("round",) + PART_KEYS:
            if k in pst.get("comm", {}):
                assert torch.equal(tst["comm"][k], pst["comm"][k]), k
        for k in ("mass", "backlog_w"):
            if k in pst.get("comm", {}):
                np.testing.assert_allclose(tst["comm"][k], pst["comm"][k],
                                           **MASS_TOL)
        assert set(tm) == set(pm)
        for k in tm:
            if k.startswith("wire_bytes") or k in EXACT_METRICS + PART_KEYS:
                np.testing.assert_array_equal(_np(tm[k]), _np(pm[k]),
                                              err_msg=k)


@pytest.mark.parametrize("name", ["push_sum-2hops-bf16", "faulty-server-adamw",
                                  "hier-ring-push_sum", "async-bf16-downlink",
                                  "faulty-gossip-g8"])
def test_round_leaves_its_state_as_it_was(name):
    """Two calls of the round on one state give the same result, bit for
    bit, and the state is as it was (no write into the caller's leaves,
    its comm state included)."""
    case = CASES[name]
    params, batch = problem(case.seed, case.g)
    _, ex = case.exchanges()
    opt = optim.get(case.opt, case.lr)
    rnd = lsgd.make_local_round(loss_t, opt, case.local_cfg(lsgd),
                                exchange=ex)
    st = lsgd.init_state(bridge.params_from_numpy(params), opt, case.g,
                         exchange=ex)
    tb = bridge.params_from_numpy(batch)
    st, _ = rnd(st, tb)                # a state mid-run: queues, buffers
    before = _clone(st)
    a, ma = rnd(st, tb)
    a = _clone(a)
    b, mb = rnd(st, tb)
    for (pa, va), (pb, vb), (p0, v0), (ps, vs) in zip(
            flat(a), flat(b), flat(before), flat(st)):
        assert pa == pb and p0 == ps
        np.testing.assert_array_equal(va, vb, err_msg=str(pa))
        np.testing.assert_array_equal(vs, v0, err_msg=str(ps))
    for k in ma:
        np.testing.assert_array_equal(_np(ma[k]), _np(mb[k]), err_msg=k)


def _tree_of(x, shapes):
    """A (G, N) array split into a tree of (G, *shape) leaves."""
    out, at = {}, 0
    for k, shape in shapes.items():
        n = int(np.prod(shape))
        out[k] = torch.tensor(x[:, at:at + n]).reshape((x.shape[0],) + shape)
        at += n
    return out


@pytest.mark.parametrize("kw", [
    dict(topology="push_sum", mix_rounds=2, drop_rate=0.3, stall_rate=0.1,
         codec="bf16"),
    dict(topology="hierarchical", n_pods=2, drop_rate=0.3,
         intra_drop_rate=0.2, codec="fp16"),
])
def test_push_sum_mass_advances_once_a_round(kw):
    """A one-leaf tree, a many-leaf tree with the same numbers and the
    packed (G, N) buffer through the same push-sum exchange over 4
    rounds: the same mass and queued weight, bit for bit (the weight
    channel advances once a round, not once a leaf or a stream), the same
    participation, and the same mixed values, element for element."""
    g, n = 4, 14
    ex = comm.get_exchange(n_groups=g, fault_seed=3, **kw)
    shapes = {"a": (3,), "b": (2, 2), "c": (7,)}
    rs = np.random.RandomState(0)
    start = np.repeat(rs.randn(1, n).astype(np.float32), g, 0)
    forms = {"packed": lambda x: torch.tensor(x),
             "one leaf": lambda x: {"w": torch.tensor(x)},
             "leaves": lambda x: _tree_of(x, shapes)}
    states = {f: ex.init(make(start)) for f, make in forms.items()}
    for _ in range(4):
        x = start + rs.randn(g, n).astype(np.float32)
        out = {}
        for f, make in forms.items():
            mixed, states[f] = ex.streams({"params": make(x)}, {},
                                          states[f])
            out[f] = (mixed["params"] if f == "packed"
                      else _packed_rows(mixed["params"], g))
        for f in ("one leaf", "leaves"):
            for k in ("mass", "backlog_w", "participation", "round"):
                assert torch.equal(states[f][k], states["packed"][k]), (f, k)
            assert torch.equal(out[f], out["packed"]), f
        m = states["leaves"]
        assert float(m["mass"].sum() + m["backlog_w"].sum()) == \
            pytest.approx(g, abs=1e-3)


def test_tree_round_launches_no_kernel(monkeypatch):
    """A tree stream never reaches codec_mix or qdq_int8 (the reference's
    _fusable takes a 2-D buffer only): with both replaced by a failure,
    the cast codecs still run on server, ring and gossip; the packed
    buffer of the same exchange is fusable."""
    def refuse(*a, **k):
        raise AssertionError("a kernel was called on the pytree round")

    monkeypatch.setattr(exchange_mod, "codec_mix", refuse)
    monkeypatch.setattr(comm.codecs, "qdq_int8", refuse)
    for name in ("server-bf16", "ring-fp16-2hops", "gossip-bf16-g8",
                 "downlink-bf16"):
        case = CASES[name]
        _, ex = case.exchanges()
        assert ex._fusable(ex.codec, torch.zeros(case.g, 8)) == (
            not ex.codec.identity)
        assert not ex._fusable(ex.codec, {"w": torch.zeros(case.g, 8)})
        port_run(case)


@pytest.mark.parametrize("topology", ["server", "ring", "async_stale",
                                      "push_sum", "hierarchical", "none"])
def test_tree_round_refuses_what_the_reference_refuses(topology):
    """The pytree round refuses exactly the reference's cells: a flat-only
    codec (int8, int8z, top-k) on a stream on the wire, and overlap;
    every other exchange that get_exchange builds, it takes."""
    from repro.comm import codecs as jcodecs
    G = 4
    n_built = n_refused = 0
    for codec in jcodecs.CODECS:
        for mc in ("fp32", "bf16", "int8", "int8z"):
            for down in ("", "fp16", "int8"):
                for overlap in (False, True):
                    kw = dict(moment_codec=mc, downlink_codec=down,
                              overlap=overlap,
                              n_pods=2 if topology == "hierarchical" else 0)
                    try:
                        jex = jcomm.get_exchange(topology, codec, G, **kw)
                    except (NotImplementedError, ValueError):
                        continue
                    tex = comm.get_exchange(topology, codec, G, **kw)
                    for avg in (True, False):
                        refused = []
                        for pkg, ex, opt in ((jlsgd, jex, joptim.adamw(0.1)),
                                             (lsgd, tex, optim.adamw(0.1))):
                            try:
                                pkg.make_local_round(
                                    loss_j if pkg is jlsgd else loss_t, opt,
                                    pkg.LocalSGDConfig(
                                        n_groups=G, average_opt_state=avg),
                                    exchange=ex)
                                refused.append(False)
                            except NotImplementedError:
                                refused.append(True)
                        assert refused[0] == refused[1], (codec, kw, avg)
                        n_built += 1
                        n_refused += refused[0]
    # push_sum and the tiers build no flat-only stream codec; "none" runs
    # no codec
    assert n_built > n_refused >= (topology in ("server", "ring",
                                                "async_stale"))


def test_inter_int8_on_a_tree_raises_as_the_reference():
    """int8 on the server inter tier over a tree: the reference's round
    passes its checks and fails in the codec (int8 chunks a flat buffer),
    with an AttributeError; the port's does the same."""
    case = Case("sgd", 0.1, dict(topology="hierarchical", n_pods=2,
                                 intra_topology="server",
                                 inter_topology="server",
                                 inter_codec="int8"), g=4)
    with pytest.raises(AttributeError):
        ref_run(case)
    with pytest.raises(AttributeError):
        port_run(case)


SMALL = dict(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256)


def test_tree_exchange_on_the_model():
    """paper-mlp (reduced, narrowed), adamw, G 4, 2 rounds of push_sum
    under drops on the pytree round: every leaf of the params, moments and
    backlogs at MODEL_TOL (adamw's params at atol 1e-5), mass,
    participation and wire bytes as above."""
    jcfg = dataclasses.replace(jax_get_config("paper-mlp").reduced(), **SMALL)
    tcfg = dataclasses.replace(get_config("paper-mlp").reduced(), **SMALL)
    jmodel = jax_build_model(jcfg, schedule="rect")
    tmodel = build_model(tcfg, schedule="rect")
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(3)))
    tokens = next(JaxTokenPipeline(jcfg.vocab_size, 16, seed=5).batches(
        (4, 2)))["tokens"]
    kw = dict(topology="push_sum", n_groups=4, drop_rate=0.2, fault_seed=1)
    jex, tex = jcomm.get_exchange(**kw), comm.get_exchange(**kw)
    cfg = dict(n_groups=4, inner_steps=2)
    jrnd = jax.jit(jlsgd.make_local_round(
        jmodel.loss, joptim.adamw(1e-3), jlsgd.LocalSGDConfig(**cfg),
        exchange=jex))
    jst = jlsgd.init_state(params, joptim.adamw(1e-3), n_groups=4,
                           exchange=jex)
    trnd = lsgd.make_local_round(tmodel.loss, optim.adamw(1e-3),
                                 lsgd.LocalSGDConfig(**cfg), exchange=tex)
    tst = lsgd.init_state(bridge.params_from_numpy(params), optim.adamw(1e-3),
                          4, exchange=tex)
    for _ in range(2):
        jst, jm = jrnd(jst, {"tokens": jnp.asarray(tokens)})
        tst, tm = trnd(tst, {"tokens": torch.tensor(tokens)})
        js = jax.device_get(jst)
        assert_state({"params": js["params"], "opt": {}},
                     {"params": tst["params"]}, None,
                     tol=dict(MODEL_TOL, atol=1e-5))
        assert_state({"opt": js["opt"], "comm": js["comm"]},
                     {"opt": tst["opt"], "comm": tst["comm"]}, None,
                     tol=MODEL_TOL)
        assert_metrics(jax.device_get(jm), tm, None, tol=MODEL_TOL)
    assert len(tree.leaves(tst["comm"]["backlog"]["params"])) > 4
