"""Educational Markov-process and parameter-estimation studies.

Vectorized re-implementations of the two teaching scripts:

* ``Markov_process.jl`` — (a) simulation proof that constant hazard gives
  exponential TTF (10k components, per-hour Bernoulli checks -> geometric
  samples ~ exponential); (b) single-component analytical pi(t+1)=pi(t)P
  evolution vs. one MC realization vs. the steady-state limit; (c) 5-unit
  system available-capacity time series.
* ``parameter_estimation.jl`` — synthetic field logs (alternating
  exponential up/down durations) and running estimation of
  MTTF/MTTR/lambda/mu with convergence to the true rates.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from powersystemsreliabilityassessment.models import twostate
from powersystemsreliabilityassessment.sampling import markov


def exponential_proof(mttf: float = 1000.0, n_samples: int = 10000,
                      max_time: int = 5000, seed: int = 42):
    """Constant-rate failure times vs. the exponential PDF.

    The reference simulates an hourly coin flip per component
    (Markov_process.jl:35-76); the geometric(p01) hour-of-failure is
    sampled directly here (identical distribution, no loop).
    """
    p01 = 1.0 - np.exp(-1.0 / mttf)
    rng = np.random.default_rng(seed)
    # geometric: number of failures BEFORE success semantics -> hours 0,1,..
    times = rng.geometric(p01, n_samples).astype(np.float64) - 1.0
    times = times[times <= max_time]
    t_theory = np.arange(0, max_time, 10.0)
    pdf_theory = (1.0 / mttf) * np.exp(-t_theory / mttf)
    return times, t_theory, pdf_theory


@dataclasses.dataclass
class SingleComponentStudy:
    prob_down_analytical: np.ndarray   # [T]
    mc_realization: np.ndarray         # [T] 0/1
    steady_state: float


def single_component_study(mttf: float = 1000.0, mttr: float = 50.0,
                           steps: int = 200,
                           seed: int = 42) -> SingleComponentStudy:
    """Analytical evolution vs MC realization (Markov_process.jl:81-144)."""
    p_ana = twostate.availability_evolution(mttf, mttr, steps)
    p01, p10 = twostate.transition_probs(np.array([mttf]), np.array([mttr]))
    path = markov.sample_markov_chain(
        jax.random.key(seed), jnp.asarray(p01, jnp.float32),
        jnp.asarray(p10, jnp.float32), steps)
    return SingleComponentStudy(
        prob_down_analytical=p_ana,
        mc_realization=np.asarray(path[0]).astype(np.int32),
        steady_state=float(mttr / (mttf + mttr)),
    )


def multi_unit_capacity_series(seed: int = 42, hours: int = 1000):
    """5-generator available-capacity series (Markov_process.jl:149-207)."""
    mttf = np.array([1000.0, 1200.0, 800.0, 1500.0, 2000.0])
    mttr = np.array([50.0, 60.0, 40.0, 20.0, 100.0])
    caps = np.array([100.0, 100.0, 50.0, 200.0, 150.0])
    p01, p10 = twostate.transition_probs(mttf, mttr)
    path = markov.sample_markov_chain(
        jax.random.key(seed), jnp.asarray(p01, jnp.float32),
        jnp.asarray(p10, jnp.float32), hours)          # [5, H] down
    cap = (1.0 - np.asarray(path, np.float32).T) @ caps
    return cap, float(caps.sum())


@dataclasses.dataclass
class EstimationStudy:
    up_durations: np.ndarray
    down_durations: np.ndarray
    est_mttf: float
    est_mttr: float
    est_lambda: float
    est_mu: float
    running_lambda: np.ndarray
    true_lambda: float


def parameter_estimation_study(true_mttf: float = 200.0,
                               true_mttr: float = 50.0,
                               n_events: int = 6, n_long: int = 1000,
                               seed: int = 123) -> EstimationStudy:
    """Field-log simulation + running rate estimation
    (parameter_estimation.jl:12-114)."""
    rng = np.random.default_rng(seed)
    ups = -true_mttf * np.log(rng.uniform(size=n_events))
    downs = -true_mttr * np.log(rng.uniform(size=n_events))
    mttf, mttr, lam, mu = twostate.estimate_rates(ups, downs)
    long_ups = -true_mttf * np.log(rng.uniform(size=n_long))
    return EstimationStudy(
        up_durations=ups, down_durations=downs,
        est_mttf=mttf, est_mttr=mttr, est_lambda=lam, est_mu=mu,
        running_lambda=twostate.running_lambda_estimate(long_ups),
        true_lambda=1.0 / true_mttf,
    )
