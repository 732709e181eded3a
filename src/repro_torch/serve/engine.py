"""Slot-based continuous-batching scheduler over the paged pool
(counterpart of ``repro/serve/engine.py``).

N batch slots drive one fixed-shape decode step for the engine's whole
life. Each tick the scheduler (1) admits queued requests into free
slots: one fenced prefill per admission claims the slot's full page
budget from the FreeList and writes the prompt's KV (and, for the
recurrent families, its state) into the pool; (2)
runs one batched decode step over all slots (inactive slots ride along
against the trash page); (3) reads the step's tokens once, commits them
and retires finished requests, freeing their rows.

``policy="static"`` is the baseline: the same engine and programs, but
admission waits until every slot is idle, so any gain of
``"continuous"`` is scheduling alone.

Backpressure: admission defers (the request stays queued) when the
FreeList cannot cover a full slot; if the pool cannot hold even one
request with every slot idle, the engine raises.

The pool, and every tensor a step makes, lives on the params' device.
Timing is phase-fenced (``obs.Trace``: ``prefill`` and ``decode_step``
synchronize the card before reading the clock) and each tick emits a
``kind="step"`` record; ``drive_workload`` runs a virtual clock over
those fenced durations.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.obs.trace import Trace
from repro_torch.serve import decode as sdecode
from repro_torch.serve.paging import FreeList


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (len,) int32 token ids
    max_new: int                  # generated tokens incl. the prefill token
    arrival: float = 0.0          # virtual-clock arrival time (seconds)


@dataclasses.dataclass
class Completion:
    rid: int
    prompt_len: int
    tokens: List[int]             # all generated tokens, prefill's first
    arrival: float
    finish_clock: float = 0.0

    @property
    def latency(self) -> float:
        return self.finish_clock - self.arrival


@dataclasses.dataclass
class StepReport:
    prefill_s: float
    decode_s: float
    admitted: int
    committed: int                # tokens committed this step (all slots)
    completions: List[Completion]

    @property
    def elapsed_s(self) -> float:
        return self.prefill_s + self.decode_s


@dataclasses.dataclass
class EngineConfig:
    n_slots: int = 4
    page_size: int = 8
    max_prompt: int = 16          # rounded up to a page multiple (bucket P)
    max_new: int = 16             # hard per-request cap
    impl: str = "auto"            # attention kernels: auto | torch | cuda
    policy: str = "continuous"    # "continuous" | "static"
    n_pages: Optional[int] = None  # pool-size override (backpressure tests)


@dataclasses.dataclass
class _Slot:
    req: Request
    target: int                   # clamped max_new
    rows: np.ndarray              # full allocation (for free())
    rows_k: np.ndarray            # (layers_kv, max_blocks)
    rows_v: np.ndarray
    srows: np.ndarray             # (state_rows,) recurrent-state rows
    pos: int                      # tokens resident in the cache
    tokens: List[int]


class Engine:
    def __init__(self, model, params, cfg: EngineConfig,
                 trace: Optional[Trace] = None):
        if cfg.policy not in ("continuous", "static"):
            raise ValueError(f"unknown policy {cfg.policy!r}")
        self.model, self.params, self.cfg = model, params, cfg
        self.bucket = cfg.page_size * (-(-cfg.max_prompt // cfg.page_size))
        self.geom = sdecode.geom_for(
            model, n_slots=cfg.n_slots, page_size=cfg.page_size,
            max_len=self.bucket + cfg.max_new, n_pages=cfg.n_pages)
        self.progs = sdecode.build_programs(model, self.geom, cfg.impl)
        self.pool = self.geom.pool(params["embed"].device)
        self.free = FreeList(self.geom.n_pages)
        self.slots: List[Optional[_Slot]] = [None] * cfg.n_slots
        self.queue: deque = deque()
        self.trace = trace if trace is not None else Trace(None)
        self.step_idx = 0
        self.deferred_total = 0   # admissions deferred by the FreeList

    # -- scheduling --------------------------------------------------------

    def submit(self, req: Request) -> None:
        if not 1 <= len(req.prompt) <= self.bucket:
            raise ValueError(f"prompt of {len(req.prompt)} tokens, the "
                             f"bucket holds 1..{self.bucket}")
        if req.max_new < 1:
            raise ValueError(f"max_new {req.max_new} < 1")
        self.queue.append(req)

    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def _admit(self, slot_id: int, req: Request) -> bool:
        g = self.geom
        rows = self.free.alloc(g.rows_per_slot)
        if rows is None:
            if self.n_active() == 0:
                raise RuntimeError(
                    f"pool too small for a single request: need "
                    f"{g.rows_per_slot} rows, have {self.free.available()}")
            return False                     # backpressure: stay queued
        nk = g.n_layers_kv * g.max_blocks
        rows_k = rows[:nk].reshape(g.n_layers_kv, g.max_blocks)
        rows_v = rows[nk:2 * nk].reshape(g.n_layers_kv, g.max_blocks)
        srows = rows[2 * nk:]
        prompt = np.asarray(req.prompt, np.int32)
        toks = np.zeros((1, self.bucket), np.int32)
        toks[:, :len(prompt)] = prompt[None]
        with self.trace.phase("prefill") as t:
            tok0, self.pool = t(self.progs.prefill(
                self.params, self.pool, toks, len(prompt), rows_k, rows_v,
                srows))
        self.slots[slot_id] = _Slot(
            req=req, target=min(req.max_new, self.cfg.max_new), rows=rows,
            rows_k=rows_k, rows_v=rows_v, srows=srows, pos=len(prompt),
            tokens=[int(tok0[0])])
        return True

    def _retire(self, slot_id: int) -> Completion:
        s = self.slots[slot_id]
        self.free.free(s.rows)
        self.slots[slot_id] = None
        return Completion(rid=s.req.rid, prompt_len=len(s.req.prompt),
                          tokens=s.tokens, arrival=s.req.arrival)

    def _batch_args(self) -> Tuple[np.ndarray, ...]:
        B, g = self.cfg.n_slots, self.geom
        tokens = np.zeros((B,), np.int32)
        pos = np.zeros((B,), np.int32)
        rows_k = np.zeros((B, g.n_layers_kv, g.max_blocks), np.int32)
        rows_v = np.zeros_like(rows_k)
        srows = np.zeros((B, g.state_rows), np.int32)
        active = np.zeros((B,), bool)
        for i, s in enumerate(self.slots):
            if s is None:
                continue          # trash tables: rows 0, pos 0, token 0
            tokens[i] = s.tokens[-1]
            pos[i] = s.pos
            rows_k[i], rows_v[i], srows[i] = s.rows_k, s.rows_v, s.srows
            active[i] = True
        return tokens, pos, rows_k, rows_v, active, srows

    def step(self) -> StepReport:
        """One scheduler tick: admit -> batched decode -> commit/retire.
        Emits one kind="step" trace record with fenced phase durations."""
        admitted, deferred = 0, 0
        can_admit = (self.cfg.policy == "continuous"
                     or self.n_active() == 0)
        while can_admit and self.queue and None in self.slots:
            if not self._admit(self.slots.index(None), self.queue[0]):
                deferred += 1        # free slot, but the pool said no
                break
            self.queue.popleft()
            admitted += 1
        self.deferred_total += deferred
        completions: List[Completion] = []
        committed = admitted      # each prefill committed one token
        for i, s in enumerate(self.slots):
            if s is not None and len(s.tokens) >= s.target:
                completions.append(self._retire(i))   # max_new == 1
        if self.n_active():
            args = self._batch_args()
            with self.trace.phase("decode_step") as t:
                toks, self.pool = t(self.progs.step(
                    self.params, self.pool, *args))
            toks = toks.cpu().numpy()      # the step's one read of tokens
            for i, s in enumerate(self.slots):
                if s is None:
                    continue
                s.pos += 1        # the token just fed is now in the cache
                s.tokens.append(int(toks[i]))
                committed += 1
                if len(s.tokens) >= s.target:
                    completions.append(self._retire(i))
        prefill_s = self.trace.phase_seconds("prefill")
        decode_s = self.trace.phase_seconds("decode_step")
        self.trace.emit_round(self.step_idx, metrics={
            "active": self.n_active(), "queued": len(self.queue),
            "admitted": admitted, "committed": committed,
            "completed": len(completions), "deferred": deferred,
            "deferred_total": self.deferred_total,
            "free_rows": self.free.available()}, kind="step")
        self.step_idx += 1
        return StepReport(prefill_s, decode_s, admitted, committed,
                          completions)

    def run(self, requests, max_steps: int = 100_000) -> List[Completion]:
        """Submit everything, step until drained (no arrival process)."""
        for r in requests:
            self.submit(r)
        done: List[Completion] = []
        while (self.queue or self.n_active()) and max_steps:
            done.extend(self.step().completions)
            max_steps -= 1
        if self.queue or self.n_active():
            raise RuntimeError("max_steps exceeded")
        return done

    def warmup(self) -> None:
        """Run one tiny request through both programs before anything is
        timed for real (the kernels' build and first launches)."""
        self.run([Request(rid=-1, prompt=np.zeros(1, np.int32),
                          max_new=2)])


# ---------------------------------------------------------------------------
# Workloads
# ---------------------------------------------------------------------------


def poisson_workload(rate: float, n: int, seed: int = 0,
                     prompt_len=(4, 16), max_new=(4, 16),
                     vocab: int = 256) -> List[Request]:
    """n requests with exponential inter-arrivals at ``rate`` req/s and
    uniform prompt/max_new draws (inclusive ranges); the reference's
    numpy draws, so both packages make the same requests from a seed."""
    rng = np.random.default_rng(seed)
    t, reqs = 0.0, []
    for i in range(n):
        t += float(rng.exponential(1.0 / rate))
        pl = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        mn = int(rng.integers(max_new[0], max_new[1] + 1))
        reqs.append(Request(
            rid=i, prompt=rng.integers(0, vocab, size=pl).astype(np.int32),
            max_new=mn, arrival=t))
    return reqs


def drive_workload(engine: Engine, requests: List[Request]):
    """Discrete-event drive: the virtual clock advances by each step's
    fenced duration, arrivals are released at their timestamps, and a
    request's latency is its completion clock minus its arrival. Returns
    (completions, makespan_seconds)."""
    reqs = sorted(requests, key=lambda r: r.arrival)
    clock, i = 0.0, 0
    done: List[Completion] = []
    while i < len(reqs) or engine.queue or engine.n_active():
        while i < len(reqs) and reqs[i].arrival <= clock:
            engine.submit(reqs[i])
            i += 1
        if not engine.queue and not engine.n_active():
            clock = reqs[i].arrival      # idle: jump to the next arrival
            continue
        rep = engine.step()
        clock += rep.elapsed_s
        for c in rep.completions:
            c.finish_clock = clock
            done.append(c)
    return done, clock
