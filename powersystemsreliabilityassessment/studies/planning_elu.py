"""Planning-feature studies: maintenance + LFU + energy-limited units.

Covers three reference drivers:

* ``generating_adequacy_comprehensive.jl`` — full planning simulation:
  maintenance scheduling, iterative ELU q-update, weekly-COPT hourly risk.
* ``MCvsMarkovProcess.jl`` / ``generating_adequancy_comparative.jl`` —
  analytical-with-ELU vs. explicit-energy-state Monte Carlo, with the
  "< 20% difference" success gate (MCvsMarkovProcess.jl:330-335).
* ``tail_risk.jl`` — full annual-LOLE distribution vs. analytical mean,
  hourly risk profiles, cumulative risk curves, extended here with
  VaR/CVaR tail metrics.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from powersystemsreliabilityassessment.engines import elu as elu_mod
from powersystemsreliabilityassessment.engines import planning
from powersystemsreliabilityassessment.engines.planning import PlanningFleet


def demo_planning_fleet(hydro_hours: float = 600.0) -> PlanningFleet:
    """The 6-unit planning fleet (MCvsMarkovProcess.jl:295-306);
    ``hydro_hours=50`` reproduces the tail_risk.jl water-shortage variant."""
    return PlanningFleet(
        names=["Nuclear", "Coal_A", "Coal_B", "Gas", "Hydro_ELU", "Old_56"],
        capacity=np.array([400.0, 300.0, 300.0, 150.0, 200.0, 56.0]),
        for_rate=np.array([0.02, 0.04, 0.04, 0.05, 0.01, 0.10]),
        maint_weeks=np.array([4, 3, 3, 2, 2, 0]),
        energy_limit=np.array([np.inf, np.inf, np.inf, np.inf,
                               200.0 * hydro_hours, np.inf]),
    )


def demo_planning_load(hours: int = 8760, seed: int = 0) -> np.ndarray:
    """Load curve of the planning demos (MCvsMarkovProcess.jl:309-311)."""
    h = np.arange(1, hours + 1)
    rng = np.random.default_rng(seed)
    load = (750.0 + 300.0 * np.sin((h - 2000) / hours * 2 * np.pi)
            + 50.0 * rng.standard_normal(hours))
    return np.maximum(load, 0.0)


def weekly_peaks_of(load: np.ndarray) -> np.ndarray:
    n_weeks = 52
    return np.array([load[w * 168: min((w + 1) * 168, len(load))].max()
                     for w in range(n_weeks)])


@dataclasses.dataclass
class PlanningResult:
    maint_start: np.ndarray
    effective_q: np.ndarray
    q_history: list
    hourly_risk: np.ndarray
    lole_hr_yr: float

    def to_dict(self) -> dict[str, Any]:
        return {
            "maint_start": self.maint_start.tolist(),
            "effective_q": self.effective_q.tolist(),
            "q_history": [q.tolist() for q in self.q_history],
            "lole_hr_yr": self.lole_hr_yr,
        }


def run_planning_analytical(fleet: PlanningFleet, load: np.ndarray,
                            step: float = 20.0,
                            lfu_sigma_percent: float = 5.0,
                            elu_iters: int = 5) -> PlanningResult:
    """Full analytical planning pipeline (comprehensive.jl main loop)."""
    lfu_mw = float(load.max()) * lfu_sigma_percent / 100.0
    planning.schedule_maintenance(fleet, weekly_peaks_of(load))
    planning.iterate_elu(fleet, load, lfu_mw, step, elu_iters)
    risk = planning.weekly_hourly_risk(fleet, load, lfu_mw, step)
    return PlanningResult(
        maint_start=fleet.maint_start.copy(),
        effective_q=fleet.effective_q.copy(),
        q_history=list(fleet.q_history),
        hourly_risk=risk,
        lole_hr_yr=float(risk.sum()),
    )


@dataclasses.dataclass
class ELUComparisonResult:
    analytical_lole: float
    mc_lole: float
    diff_percent: float
    success: bool                  # < 20% gate, MCvsMarkovProcess.jl:330
    mc_yearly_distribution: np.ndarray
    mc_hourly_profile: np.ndarray
    analytical_hourly_profile: np.ndarray
    var95: float
    cvar95: float

    def to_dict(self) -> dict[str, Any]:
        return {
            "analytical_lole": self.analytical_lole,
            "mc_lole": self.mc_lole,
            "diff_percent": self.diff_percent,
            "success": self.success,
            "var95": self.var95,
            "cvar95": self.cvar95,
        }


def run_elu_comparison(fleet: PlanningFleet | None = None,
                       load: np.ndarray | None = None,
                       mc_years: int = 1000, step: float = 20.0,
                       lfu_sigma_percent: float = 5.0,
                       seed: int = 0) -> ELUComparisonResult:
    """Analytical-with-ELU vs. energy-state Monte Carlo
    (MCvsMarkovProcess.jl run_comparison / tail_risk.jl pipeline)."""
    fleet = fleet if fleet is not None else demo_planning_fleet()
    load = load if load is not None else demo_planning_load()
    lfu_mw = float(load.max()) * lfu_sigma_percent / 100.0

    ana = run_planning_analytical(fleet, load, step, lfu_sigma_percent)

    lole_y, hourly = elu_mod.run_elu_mc(
        jax.random.key(seed),
        jnp.asarray(fleet.capacity, jnp.float32),
        jnp.asarray(fleet.for_rate, jnp.float32),
        jnp.asarray(fleet.maint_start, jnp.int32),
        jnp.asarray(fleet.maint_weeks, jnp.int32),
        jnp.asarray(np.where(np.isfinite(fleet.energy_limit),
                             fleet.energy_limit, np.inf), jnp.float32),
        jnp.asarray(load, jnp.float32),
        lfu_mw, mc_years)
    mc_lole = float(lole_y.mean())
    diff = abs(mc_lole - ana.lole_hr_yr) / max(ana.lole_hr_yr, 1e-12) * 100
    var95, cvar95 = elu_mod.var_cvar(lole_y, 0.95)
    return ELUComparisonResult(
        analytical_lole=ana.lole_hr_yr,
        mc_lole=mc_lole,
        diff_percent=diff,
        success=diff < 20.0,
        mc_yearly_distribution=np.asarray(lole_y),
        mc_hourly_profile=np.asarray(hourly),
        analytical_hourly_profile=ana.hourly_risk,
        var95=float(var95),
        cvar95=float(cvar95),
    )


def run_tail_risk_study(mc_years: int = 2000, seed: int = 0
                        ) -> ELUComparisonResult:
    """tail_risk.jl variant: 50-hour hydro energy limit exposes the gap
    between the analytical mean and the heavy-tailed MC distribution."""
    return run_elu_comparison(demo_planning_fleet(hydro_hours=50.0),
                              mc_years=mc_years, seed=seed)
