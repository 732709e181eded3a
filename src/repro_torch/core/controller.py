"""Adaptive-T controller (paper Sec 4, 'detect the order of local convergence
on the fly, then use these estimates as a guideline to adjust T'). A copy
of ``repro/core/controller.py`` over the port's ``theory``; ``from_exchange``
prices the port's ``comm.Exchange``."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core import theory


@dataclasses.dataclass
class AdaptiveT:
    """Adjusts the number of local steps between communication rounds.

    r: cost ratio C_g / C_c (local step cost / communication cost). Two
    ways to instantiate it:

    * roofline estimate (the fallback): r = step_time_est /
      allreduce_time_est from the dry-run HLO terms (launch/roofline.py).
    * measured, codec-aware: ``AdaptiveT.from_comm_bytes`` takes the EXACT
      per-round wire bytes the round's Exchange reports
      (``metrics["wire_bytes"]`` / ``Exchange.wire_bytes_per_round``) and
      a link bandwidth — so switching codec (int8 cuts bytes ~4x) changes
      r, and with it the cost-optimal T*.
    """

    r: float
    t_min: int = 1
    t_max: int = 10_000
    ema: float = 0.5                    # smoothing of T across rounds
    _t: float = 10.0
    history: Optional[List] = None

    def __post_init__(self):
        self.history = []

    @classmethod
    def from_comm_bytes(cls, step_time_s: float, wire_bytes_per_round: float,
                        bandwidth_bytes_per_s: float,
                        **kw) -> "AdaptiveT":
        """r from MEASURED communication: C_c = wire_bytes / bandwidth.

        ``wire_bytes_per_round`` is the codec-aware payload the comm
        subsystem accounts per round; ``step_time_s`` the measured (or
        roofline) cost of one local step."""
        comm_s = wire_bytes_per_round / bandwidth_bytes_per_s
        if comm_s <= 0:
            raise ValueError(f"non-positive comm time {comm_s} "
                             "(zero wire bytes? the 'none' topology has "
                             "no communication cost to adapt T against)")
        return cls(r=step_time_s / comm_s, **kw)

    @classmethod
    def from_exchange(cls, step_time_s: float, exchange, n_params: int,
                      moment_sizes=None, *,
                      bandwidth_bytes_per_s: float = 50e9,
                      inter_bandwidth_bytes_per_s: Optional[float] = None,
                      delivery_rate: Optional[float] = None,
                      **kw) -> "AdaptiveT":
        """r priced from an Exchange's OWN stream-resolved accounting
        (DESIGN.md §10): the payload is the params through the params
        codec plus every moment stream through the moment codec —
        switching ``moment_codec`` (int8 moments cut adamw's dominant
        wire term ~4x) changes r, and with it the cost-optimal T*.
        ``moment_sizes``: {stream: elems} of the moment buffers the round
        averages (omit for params-only / average_opt_state=False).

        On a lossy network (DESIGN.md §12) a round's accounted bytes
        understate the cost of USEFUL communication: a payload that
        needed 1/delivery attempts (server retries from the pushed
        buffer) — or whose queued mass arrives a round late
        (push_sum's delivered-edge pricing) — buys less consensus per
        round. ``delivery_rate`` (default: the exchange's own FaultPlan
        expectation) divides the accounted bytes by the expected
        delivery fraction, so faults make communication more expensive
        per useful round, shrink r, and push T* UP — fewer, longer
        rounds on an unreliable network.

        Hierarchical exchanges (DESIGN.md §16) price the two tiers on
        their OWN links: the intra-pod bytes over
        ``bandwidth_bytes_per_s`` at the intra tier's delivery rate, the
        cross-pod bytes over ``inter_bandwidth_bytes_per_s`` (the slower
        DCN; defaults to the intra bandwidth) at the inter tier's — a
        lossy DCN raises only the cross-pod term, which is usually the
        dominant one, so T* still moves the right way."""
        if getattr(exchange, "hierarchical", False):
            by_tier = exchange.wire_bytes_by_tier(
                n_params, moment_sizes=moment_sizes)
            bw_x = inter_bandwidth_bytes_per_s or bandwidth_bytes_per_s
            d_i = exchange.delivery_rate_intra
            d_x = exchange.delivery_rate_inter
            if not (0.0 < d_i <= 1.0 and 0.0 < d_x <= 1.0):
                raise ValueError(f"per-tier delivery rates ({d_i}, {d_x}) "
                                 "not in (0, 1]")
            comm_s = (by_tier["intra"] / (bandwidth_bytes_per_s * d_i)
                      + by_tier["inter"] / (bw_x * d_x))
            if comm_s <= 0:
                raise ValueError(f"non-positive comm time {comm_s}")
            return cls(r=step_time_s / comm_s, **kw)
        wire = exchange.wire_bytes_per_round(n_params,
                                             moment_sizes=moment_sizes)
        if delivery_rate is None:
            delivery_rate = getattr(exchange, "delivery_rate", 1.0)
        if not 0.0 < delivery_rate <= 1.0:
            raise ValueError(f"delivery_rate {delivery_rate} not in (0, 1]")
        return cls.from_comm_bytes(step_time_s, wire / delivery_rate,
                                   bandwidth_bytes_per_s, **kw)

    @property
    def t(self) -> int:
        return int(np.clip(round(self._t), self.t_min, self.t_max))

    def update(self, grad_sq_traj) -> int:
        """Feed the last round's per-step local ||grad||^2 trajectory.
        Degenerate trajectories (diverged, constant, too short) leave T
        unchanged."""
        fit = theory.fit_decay(np.asarray(grad_sq_traj))
        if fit is not None:
            try:
                t_star = theory.t_star_from_fit(fit, self.r)
            except (ValueError, OverflowError):
                return self.t
            self._t = self.ema * self._t + (1.0 - self.ema) * t_star
            self.history.append((fit, t_star, self.t))
        return self.t


@dataclasses.dataclass
class OnlineT:
    """Per-round T controller driven by the measured round telemetry
    (``--adaptive-t online``, DESIGN.md §14).

    ``AdaptiveT`` prices the cost ratio r ONCE from static wire bytes and
    then only re-fits the local decay order. With the §13/§14 signal set
    complete — consensus distance pre/post exchange, per-stream codec
    error mass, and honestly fenced phase times — the tradeoff can be
    re-estimated every round from what actually happened:

    * **cost ratio online**: r̂ = EMA of (local_s / T) / exchange_s from
      the fenced phase times, so codec switches, overlap hiding, and
      real link speed all move r without a bandwidth guess;
    * **consensus guard**: γ̂ = EMA of (consensus_post + codec_err) /
      consensus_pre measures how much deviation one exchange actually
      retires. Weak mixing (γ̂ → 1: lossy codec, sparse gossip) means
      long local bursts drift apart faster than rounds can pull them
      back — T is scaled by (1 − γ̂);
    * **convergence relief**: as the run converges the groups agree,
      exchanges buy little, and rounds should lengthen — T is scaled by
      sqrt(c₀ / consensus_pre) (clipped to [1, relief_max]), which ramps
      T up as consensus distance falls below its initial mass c₀. Fewer
      rounds at the tail is where online-T beats static T* on total
      wire bytes;
    * **divergence guard** (DESIGN.md §14): the round map for consensus
      mass is c ← γ̂ · c · e^{a·T} — local steps grow deviation at a
      measured per-step exponent a (drift gain = consensus_pre of this
      round over consensus_post of the previous one, spread over the T
      steps between them), the exchange contracts it by γ̂. The map is
      stable only for T < ln(1/γ̂)/a; when the measured â is positive T
      is CLAMPED to guard_margin · ln(1/γ̂)/â. The multiplicative
      (1 − γ̂) factor slows T growth but cannot bound it when the
      relief/cost terms push harder; the clamp is what actually keeps
      aggressive-lr decentralized runs (the §14 divergent corner) from
      compounding consensus mass round over round.

    The cost-optimal core is still the paper's Sec-4 T* from the fitted
    decay order; the two telemetry factors multiply it, and the result
    is EMA-smoothed exactly like ``AdaptiveT``. Missing signals
    degrade gracefully: with no timing the ratio keeps its prior, with
    no consensus telemetry both factors stay 1 and the controller
    reduces to ``AdaptiveT`` with a measured r.
    """

    r: float = 1.0
    t_min: int = 1
    t_max: int = 10_000
    ema: float = 0.5            # smoothing of T across rounds
    r_ema: float = 0.7          # smoothing of the measured cost ratio
    guard_ema: float = 0.5      # smoothing of the consensus guard
    relief_max: float = 8.0     # cap on the convergence relief factor
    guard_margin: float = 0.5   # stay this far inside the stability edge
    _t: float = 10.0
    _gamma: float = 0.0
    _c0: Optional[float] = None
    _a: float = 0.0             # EMA'd per-step drift exponent â
    _prev_post: Optional[float] = None
    history: Optional[List] = None

    def __post_init__(self):
        self.history = []

    @property
    def t(self) -> int:
        return int(np.clip(round(self._t), self.t_min, self.t_max))

    def update(self, grad_sq_traj, *, t_used: int,
               local_s: Optional[float] = None,
               exchange_s: Optional[float] = None,
               consensus_pre: Optional[float] = None,
               consensus_post: Optional[float] = None,
               codec_err: float = 0.0) -> int:
        """Feed one round's telemetry; returns the next round's T.

        ``grad_sq_traj``: per-step local ||grad||² trajectory (metrics
        ``grad_sq_traj``, group-mean). ``t_used``: the T the round
        actually ran. ``local_s`` / ``exchange_s``: fenced phase times
        (``local_total_s``, ``exchange_total_s``). ``consensus_pre`` /
        ``consensus_post``: group-mean ``consensus_sq`` /
        ``consensus_sq_post``. ``codec_err``: summed group-mean
        ``codec_err/*`` mass."""
        # -- cost ratio from the fenced phase times -----------------------
        if (local_s is not None and exchange_s is not None
                and local_s > 0.0 and exchange_s > 0.0 and t_used >= 1):
            r_meas = (local_s / t_used) / exchange_s
            self.r = self.r_ema * self.r + (1.0 - self.r_ema) * r_meas
        # -- consensus guard ----------------------------------------------
        if (consensus_pre is not None and consensus_post is not None
                and consensus_pre > 0.0):
            gamma = float(np.clip(
                (consensus_post + codec_err) / consensus_pre, 0.0, 0.95))
            self._gamma = (self.guard_ema * self._gamma
                           + (1.0 - self.guard_ema) * gamma)
        # -- divergence guard: measured per-step drift exponent -----------
        if (consensus_pre is not None and self._prev_post is not None
                and self._prev_post > 0.0 and consensus_pre > 0.0
                and t_used >= 1):
            drift_gain = consensus_pre / self._prev_post
            a_meas = float(np.log(max(drift_gain, 1.0 + 1e-6))) / t_used
            self._a = (self.guard_ema * self._a
                       + (1.0 - self.guard_ema) * a_meas)
        if consensus_post is not None:
            self._prev_post = float(consensus_post)
        # -- convergence relief -------------------------------------------
        relief = 1.0
        if consensus_pre is not None and consensus_pre > 0.0:
            if self._c0 is None:
                self._c0 = float(consensus_pre)
            relief = float(np.clip(np.sqrt(self._c0 / consensus_pre),
                                   1.0, self.relief_max))
        # -- cost-optimal core (paper Sec 4) ------------------------------
        fit = theory.fit_decay(np.asarray(grad_sq_traj))
        t_cost = None
        if fit is not None:
            try:
                t_cost = theory.t_star_from_fit(fit, self.r)
            except (ValueError, OverflowError):
                t_cost = None
        if t_cost is None:
            t_cost = self._t
        target = t_cost * (1.0 - self._gamma) * relief
        self._t = self.ema * self._t + (1.0 - self.ema) * target
        # -- stability clamp: T < guard_margin * ln(1/γ̂) / â --------------
        t_guard = None
        if self._a > 0.0 and self._gamma > 0.0:
            t_guard = int(np.floor(
                self.guard_margin
                * np.log(1.0 / (self._gamma + 1e-6)) / self._a))
            self._t = min(self._t, float(max(t_guard, self.t_min)))
        self.history.append({"r": self.r, "gamma": self._gamma,
                             "relief": relief, "t_cost": t_cost,
                             "a": self._a, "t_guard": t_guard,
                             "t": self.t})
        return self.t
