"""Generation-planning features on top of the COPT engine:

* maintenance scheduling by reserve levelization
  (``generating_adequacy_comprehensive.jl:86-112`` /
  ``MCvsMarkovProcess.jl:44-71``): greedy largest-burden-first placement of
  each unit's maintenance window to maximize the minimum weekly reserve.
  Host-side numpy — it is a 52 x units search run once per study.
* iterative energy-limited-unit (ELU) effective-FOR adjustment
  (``generating_adequacy_comprehensive.jl:118-175``,
  ``MCvsMarkovProcess.jl:116-164``): expected energy required from the unit
  against the rest-of-system COPT (under the 7-point LFU mixture); any
  excess over the energy limit converts into an additive unavailability.
* weekly-COPT hourly risk profile with maintenance masking and LFU
  (``generating_adequacy_comprehensive.jl:181-271``): one COPT per week
  built by zeroing the capacity of units on maintenance (a zero-capacity
  convolution step is the identity, so the weekly COPTs batch under vmap
  with static shapes).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from powersystemsreliabilityassessment.engines import copt as copt_mod

HOURS_PER_WEEK = 168
N_WEEKS = 52


@dataclasses.dataclass
class PlanningFleet:
    """Host-side fleet description for planning studies."""
    names: list
    capacity: np.ndarray        # [G] MW
    for_rate: np.ndarray        # [G] base mechanical FOR (q)
    maint_weeks: np.ndarray     # [G] int weeks/yr
    energy_limit: np.ndarray    # [G] MWh, inf if unlimited
    # planning state
    effective_q: np.ndarray = None
    maint_start: np.ndarray = None  # [G] 1-based start week, 0 = none
    q_history: list = None

    def __post_init__(self):
        if self.effective_q is None:
            self.effective_q = np.asarray(self.for_rate, np.float64).copy()
        if self.maint_start is None:
            self.maint_start = np.zeros(len(self.capacity), np.int32)
        if self.q_history is None:
            self.q_history = [self.effective_q.copy()]

    @property
    def n(self) -> int:
        return len(self.capacity)


def schedule_maintenance(fleet: PlanningFleet,
                         weekly_peaks: np.ndarray) -> np.ndarray:
    """Greedy reserve-levelization schedule; fills ``fleet.maint_start``.

    Largest capacity*weeks burden first; each unit takes the window
    maximizing the minimum weekly reserve (comprehensive.jl:86-112).
    """
    total = float(fleet.capacity.sum())
    avail = np.full(N_WEEKS, total)
    order = np.argsort(-(fleet.capacity * fleet.maint_weeks))
    for g in order:
        w = int(fleet.maint_weeks[g])
        if w <= 0:
            continue
        best_start, best_res = 1, -np.inf
        for start in range(1, N_WEEKS - w + 2):
            window = slice(start - 1, start - 1 + w)
            min_res = float(np.min(avail[window] - weekly_peaks[window]))
            if min_res > best_res:
                best_res, best_start = min_res, start
        fleet.maint_start[g] = best_start
        avail[best_start - 1: best_start - 1 + w] -= fleet.capacity[g]
    return fleet.maint_start


def maintenance_mask(fleet: PlanningFleet) -> np.ndarray:
    """[52, G] bool — unit on maintenance during week (1-based weeks)."""
    weeks = np.arange(1, N_WEEKS + 1)[:, None]
    start = fleet.maint_start[None, :]
    return (start > 0) & (weeks >= start) & (weeks < start + fleet.maint_weeks[None, :])


def expected_elu_energy(fleet: PlanningFleet, unit: int,
                        base_load: np.ndarray, lfu_sigma_mw: float,
                        step: float) -> float:
    """Expected energy demanded of ``unit`` by the rest-of-system COPT.

    E = sum_h sum_z p_z * E[min(C_unit, max(0, Outage_rest - reserve_hz))]
    (MCvsMarkovProcess.jl:129-147). Evaluated exactly with suffix sums:
    E[min(C, (X - r)+)] = E[(X - r)+] - E[(X - (r + C))+].
    """
    others = np.arange(fleet.n) != unit
    caps = jnp.asarray(fleet.capacity[others], jnp.float32)
    qs = jnp.asarray(fleet.effective_q[others], jnp.float32)
    total_rest = float(fleet.capacity[others].sum())
    n_pts = copt_mod.grid_points_for(total_rest, step)
    probs = copt_mod.build_copt(caps, qs, step, n_pts)
    s = copt_mod.summarize(probs, step)
    load = jnp.asarray(base_load, jnp.float32)
    cap_u = float(fleet.capacity[unit])

    def excess(shift):
        # sum over hours of E[(X - (total_rest - load - shift...)]
        return copt_mod.expected_excess(s, total_rest, load + shift, step)

    pts = copt_mod.LFU_POINTS
    ws = copt_mod.LFU_PROBS
    total = 0.0
    for z, w in zip(pts, ws):
        shift = float(z) * lfu_sigma_mw
        e_r = float(excess(shift))
        e_rc = float(excess(shift - cap_u))  # reserve + C ≡ load - C
        total += w * (e_r - e_rc)
    return total


def update_elu(fleet: PlanningFleet, base_load: np.ndarray,
               lfu_sigma_mw: float, step: float,
               hours: int | None = None) -> bool:
    """One ELU effective-q update pass; returns True if any q changed.

    q_eff = q_base + max(0, E_required - E_limit) / (C * 8760)
    (MCvsMarkovProcess.jl:149-159).
    """
    hours = hours or len(base_load)
    changed = False
    for g in range(fleet.n):
        if not np.isfinite(fleet.energy_limit[g]):
            continue
        e_req = expected_elu_energy(fleet, g, base_load, lfu_sigma_mw, step)
        new_q = float(fleet.for_rate[g])
        if e_req > fleet.energy_limit[g]:
            new_q += (e_req - fleet.energy_limit[g]) / (
                fleet.capacity[g] * hours)
        new_q = min(new_q, 1.0)
        if abs(new_q - fleet.effective_q[g]) > 1e-5:
            fleet.effective_q[g] = new_q
            changed = True
    fleet.q_history.append(fleet.effective_q.copy())
    return changed


def iterate_elu(fleet: PlanningFleet, base_load: np.ndarray,
                lfu_sigma_mw: float, step: float, iters: int = 5) -> None:
    """Fixed-point ELU iteration (5 passes, MCvsMarkovProcess.jl:166-169)."""
    for i in range(iters):
        if not update_elu(fleet, base_load, lfu_sigma_mw, step) and i > 0:
            break


def weekly_hourly_risk(fleet: PlanningFleet, base_load: np.ndarray,
                       lfu_sigma_mw: float, step: float) -> np.ndarray:
    """Hourly LOLP profile with per-week maintenance-masked COPTs + LFU.

    Returns [H]; LOLE = profile.sum(). Vectorized: all 52 weekly COPTs are
    built in one vmap (maintenance zeroes unit capacity — an identity
    convolution step), then every hour indexes its week's suffix table.
    """
    H = len(base_load)
    mask = maintenance_mask(fleet)                       # [52, G]
    caps_w = jnp.asarray(
        fleet.capacity[None, :] * (~mask), jnp.float32)  # [52, G]
    qs = jnp.asarray(np.broadcast_to(fleet.effective_q, mask.shape),
                     jnp.float32)
    total_cap = float(fleet.capacity.sum())
    n_pts = copt_mod.grid_points_for(total_cap, step)

    week_of_hour = jnp.asarray(
        np.minimum(np.arange(H) // HOURS_PER_WEEK, N_WEEKS - 1))
    load = jnp.asarray(base_load, jnp.float32)
    risk = _weekly_risk_jit(caps_w, qs, load, week_of_hour,
                            jnp.float32(lfu_sigma_mw), step, n_pts)
    return np.asarray(risk)


@partial(jax.jit, static_argnames=("step", "n_pts"))
def _weekly_risk_jit(caps_w, qs, load, week_of_hour, lfu_sigma_mw,
                     step: float, n_pts: int):
    """Jitted body of weekly_hourly_risk (one executable instead of ~20
    eager mini-dispatches through the remote-compile hop)."""
    probs_w = jax.vmap(
        lambda cc, qq: copt_mod.build_copt(cc, qq, step, n_pts))(caps_w, qs)
    s0 = jax.vmap(lambda p: copt_mod.summarize(p, step).suffix_prob)(probs_w)
    installed_w = jnp.sum(caps_w, axis=1)                # [52]
    inst_h = installed_w[week_of_hour]                   # [H]
    s0_h = s0[week_of_hour]                              # [H, n+1 padded]

    n = n_pts
    pts = jnp.asarray(copt_mod.LFU_POINTS, jnp.float32)
    ws = jnp.asarray(copt_mod.LFU_PROBS, jnp.float32)

    def one_z(z, w):
        reserve = inst_h - (load + z * lfu_sigma_mw)
        idx = jnp.clip(jnp.floor(reserve / step).astype(jnp.int32) + 1, 0, n)
        return w * jnp.take_along_axis(s0_h, idx[:, None], axis=1)[:, 0]

    return jnp.sum(jax.vmap(one_z)(pts, ws), axis=0)
