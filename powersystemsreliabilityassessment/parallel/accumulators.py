"""Distributed reliability-index accumulators.

The per-batch device computation produces *partial sums* (first and second
moments of DNS, failure flags, nodal shed vectors, and the
component-down-during-failure outer sums used for weak-point detection —
nsqMain.m:281-301, :345-393; seqMain.m:160-185, :215-250). Under
``shard_map`` these partials are ``psum``-reduced over the scenario mesh
axis; the host then folds successive batch partials into float64 running
statistics and evaluates the beta / coefficient-of-variation stopping rules.

Keeping the cross-batch state on host (in float64) avoids f32 cancellation
over 1e5..1e9 samples and makes checkpoint/resume trivial.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from powersystemsreliabilityassessment.parallel.mesh import SCENARIO_AXIS


class BatchMoments(NamedTuple):
    """Partial sums over one scenario batch (device side)."""
    n: jax.Array            # scalar sample count
    sum_dns: jax.Array      # scalar sum of DNS (MW)
    sum_dns_sq: jax.Array   # scalar sum of DNS^2
    sum_flag: jax.Array     # scalar count of failure states
    sum_nodal: jax.Array    # [nb] sum of nodal shed (MW)
    sum_comp_fail: jax.Array  # [n_comp] sum of comp-down over failure states
    # Raw (weighted, un-adjusted) failure count: the denominator of the
    # component-importance ratio. Equals sum_flag except in control-
    # variate mode, where sum_flag holds residuals (whose sum is the
    # near-zero count of network-only failures — dividing the raw
    # numerator by it would blow the conditional probabilities sky-high).
    sum_flag_raw: jax.Array


def batch_moments(dns_mw, nodal_mw, failure, comp_down,
                  weight=None, cv=None) -> BatchMoments:
    """Partial sums; ``weight`` [B] turns every index into an
    importance-sampling estimate (E_q[w f(X)] = E_p[f(X)]): DNS, flags
    and nodal sheds are weighted while ``n`` stays the sample COUNT, so
    the downstream mean/beta formulas compute the IS estimator and its
    CoV unchanged. Ratio indices (component importance = weighted
    comp-down-and-fail over weighted fail) also come out right.

    ``cv = (c_mw, c_flag)`` applies the copper-sheet control variate
    (studies/hl2_nsq.py ``control_variate=True``): the DNS/flag sums and
    second moment track the RESIDUALS ``w*(dns - c)`` / ``w*(flag -
    c_flag)``; the host adds back the exact copper means (RunningStats
    ``mu_dns``/``mu_flag`` offsets). Keeping the device sums residual-
    only is essential: the residuals are ~1000x smaller than the values,
    and f32 accumulation of ``sum((r + mu)^2)`` loses the entire
    residual variance to cancellation (observed: beta reported 5e-6
    where the true CoV was 1e-3, silently stopping studies early).
    Expectation is unchanged (E[w*c] = mu_C exactly, for plain,
    antithetic and importance sampling alike). Nodal and component-
    importance sums stay on the raw weighted values."""
    f = failure.astype(dns_mw.dtype)
    if weight is not None:
        dns_mw = dns_mw * weight
        nodal_mw = nodal_mw * weight[:, None]
        f = f * weight
    v, vf = dns_mw, f
    if cv is not None:
        c_mw, c_flag = cv
        cw = c_mw if weight is None else c_mw * weight
        cfw = c_flag.astype(dns_mw.dtype)
        if weight is not None:
            cfw = cfw * weight
        v = dns_mw - cw
        vf = f - cfw
    return BatchMoments(
        n=np.asarray(dns_mw.shape[0], dns_mw.dtype),
        sum_dns=jnp.sum(v),
        sum_dns_sq=jnp.sum(v * v),
        sum_flag=jnp.sum(vf),
        sum_nodal=jnp.sum(nodal_mw, axis=0),
        sum_comp_fail=f @ comp_down.astype(dns_mw.dtype),
        sum_flag_raw=jnp.sum(f),
    )


def psum_moments(m: BatchMoments) -> BatchMoments:
    """All-reduce partials over the scenario mesh axis (inside shard_map)."""
    return jax.tree.map(lambda a: jax.lax.psum(a, SCENARIO_AXIS), m)


MOMENTS_OUT_SPECS = BatchMoments(
    n=P(), sum_dns=P(), sum_dns_sq=P(), sum_flag=P(),
    sum_nodal=P(), sum_comp_fail=P(), sum_flag_raw=P())


@dataclasses.dataclass
class RunningStats:
    """Host-side float64 cross-batch accumulator (NSQ path).

    Under the control variate the dns/flag sums hold RESIDUALS (see
    batch_moments) and ``mu_dns``/``mu_flag`` carry the exact copper
    means added back at reporting time; both default to 0, so plain-MC
    behavior (and old checkpoints) are unchanged.
    """

    n: float = 0.0
    sum_dns: float = 0.0
    sum_dns_sq: float = 0.0
    sum_flag: float = 0.0
    sum_nodal: np.ndarray | None = None
    sum_comp_fail: np.ndarray | None = None
    mu_dns: float = 0.0
    mu_flag: float = 0.0
    sum_flag_raw: float = 0.0
    # Enumeration-hybrid offsets (studies/hl2_nsq.py enum_order > 0): the
    # device sums then hold tail-masked values and these carry the exact
    # enumerated contributions (sampling/enumeration.py). All default to
    # zero/None so plain-MC and CV behavior (and old checkpoints) are
    # unchanged.
    mu_nodal: np.ndarray | None = None
    mu_comp_fail: np.ndarray | None = None
    mu_flag_raw: float = 0.0

    def update(self, m: BatchMoments) -> None:
        m = jax.tree.map(lambda a: np.asarray(a, np.float64), m)
        self.n += float(m.n)
        self.sum_dns += float(m.sum_dns)
        self.sum_dns_sq += float(m.sum_dns_sq)
        self.sum_flag += float(m.sum_flag)
        self.sum_flag_raw += float(m.sum_flag_raw)
        self.sum_nodal = (m.sum_nodal if self.sum_nodal is None
                          else self.sum_nodal + m.sum_nodal)
        self.sum_comp_fail = (m.sum_comp_fail if self.sum_comp_fail is None
                              else self.sum_comp_fail + m.sum_comp_fail)

    # -- reliability indices (nsqMain.m:281-301) ---------------------------
    @property
    def edns(self) -> float:
        return self.mu_dns + self.sum_dns / max(self.n, 1.0)

    @property
    def plc(self) -> float:
        return self.mu_flag + self.sum_flag / max(self.n, 1.0)

    def lole(self, hours_per_year: float = 8760.0) -> float:
        return self.plc * hours_per_year

    @property
    def beta(self) -> float:
        """Coefficient of variation of the EDNS estimator.

        Matches nsqMain.m:297-301: sqrt(sum (dns - EDNS)^2) / (N * EDNS),
        using sum (dns-mean)^2 = sum dns^2 - N mean^2.
        """
        mean = self.edns
        if self.n <= 0 or mean <= 0:
            return float("inf")
        # Under the control variate the sums are residuals r = v - mu_C;
        # var(v) = var(r), so the spread comes from the residual moments
        # while the mean in the denominator includes the offset.
        rbar = self.sum_dns / self.n
        ss = max(self.sum_dns_sq - self.n * rbar * rbar, 0.0)
        if ss == 0.0 and self.mu_dns > 0.0:
            # CV mode with no residual variance OBSERVED yet (e.g. no
            # shed state sampled): convergence cannot be assessed.
            return float("inf")
        return float(np.sqrt(ss) / (self.n * mean))

    def nodal_eens(self, hours_per_year: float = 8760.0) -> np.ndarray:
        """Per-bus EENS MWh/yr (nsqMain.m:345-358: mean nodal DNS * 8760)."""
        mean = self.sum_nodal / max(self.n, 1.0)
        if self.mu_nodal is not None:
            mean = mean + self.mu_nodal
        return mean * hours_per_year

    def component_importance(self) -> np.ndarray:
        """P(component down | system failure) (nsqMain.m:360-376).

        Uses the RAW failure count: under the control variate
        ``sum_flag`` holds residuals whose sum is near zero, not the
        failure count. (``sum_flag_raw`` falls back to ``sum_flag`` for
        checkpoints written before the field existed — they predate CV
        mode, where the two are equal.) Under the enumeration hybrid both
        numerator and denominator combine the exact enumerated part with
        the tail-MC mean — a ratio of means, identical to the ratio of
        counts when the exact parts are zero."""
        if self.sum_comp_fail is None:
            return np.zeros(0)
        n = max(self.n, 1.0)
        num = self.sum_comp_fail / n
        if self.mu_comp_fail is not None:
            num = num + self.mu_comp_fail
        den = (self.sum_flag_raw or self.sum_flag) / n + self.mu_flag_raw
        if den == 0:
            return np.zeros(0)
        return num / den

    def state(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_state(cls, d: dict) -> "RunningStats":
        # JSON checkpoints round-trip the array fields as lists; convert
        # here so index properties work even when a restored run
        # converges before folding another batch (list / float raises).
        d = dict(d)
        for k in ("sum_nodal", "sum_comp_fail", "mu_nodal", "mu_comp_fail"):
            if d.get(k) is not None:
                d[k] = np.asarray(d[k], np.float64)
        return cls(**d)


@dataclasses.dataclass
class AnnualStats:
    """Host-side per-year accumulator (SEQ path, seqMain.m:160-198)."""

    ens: list = dataclasses.field(default_factory=list)    # MWh per year
    plc: list = dataclasses.field(default_factory=list)
    nlc: list = dataclasses.field(default_factory=list)
    dlc: list = dataclasses.field(default_factory=list)
    dns: list = dataclasses.field(default_factory=list)
    sum_nodal: np.ndarray | None = None
    sum_comp_fail: np.ndarray | None = None
    total_loss_hours: float = 0.0

    def update_years(self, ens, plc, nlc, dlc, dns, nodal_sum,
                     comp_fail_sum, loss_hours) -> None:
        self.ens.extend(np.asarray(ens, np.float64).tolist())
        self.plc.extend(np.asarray(plc, np.float64).tolist())
        self.nlc.extend(np.asarray(nlc, np.float64).tolist())
        self.dlc.extend(np.asarray(dlc, np.float64).tolist())
        self.dns.extend(np.asarray(dns, np.float64).tolist())
        nodal_sum = np.asarray(nodal_sum, np.float64)
        comp_fail_sum = np.asarray(comp_fail_sum, np.float64)
        self.sum_nodal = (nodal_sum if self.sum_nodal is None
                          else self.sum_nodal + nodal_sum)
        self.sum_comp_fail = (comp_fail_sum if self.sum_comp_fail is None
                              else self.sum_comp_fail + comp_fail_sum)
        self.total_loss_hours += float(loss_hours)

    @property
    def years(self) -> int:
        return len(self.ens)

    @property
    def eens(self) -> float:
        return float(np.mean(self.ens)) if self.ens else 0.0

    @property
    def cov(self) -> float:
        """std/(mean*sqrt(N)) with ddof=1 (seqMain.m:183-185)."""
        n = self.years
        if n < 2 or self.eens <= 0:
            return float("inf")
        s = np.std(self.ens, ddof=1)
        if s == 0.0:
            # Zero observed variance with a positive mean happens under
            # the control variate when no sampled year has shed yet
            # (every adjusted value equals mu_C exactly): convergence
            # cannot be assessed, so never report cov 0 and stop early.
            return float("inf")
        return float(s / (self.eens * np.sqrt(n)))

    def nodal_eens(self) -> np.ndarray:
        return self.sum_nodal / max(self.years, 1)

    def component_importance(self) -> np.ndarray:
        if self.sum_comp_fail is None or self.total_loss_hours == 0:
            return np.zeros(0)
        return self.sum_comp_fail / self.total_loss_hours

    @classmethod
    def from_state(cls, d: dict) -> "AnnualStats":
        # JSON checkpoints round-trip the array fields as lists (see
        # RunningStats.from_state).
        d = dict(d)
        for k in ("sum_nodal", "sum_comp_fail"):
            if d.get(k) is not None:
                d[k] = np.asarray(d[k], np.float64)
        return cls(**d)
