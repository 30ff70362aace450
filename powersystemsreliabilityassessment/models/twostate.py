"""Two-state Markov component models (layer L1 of the reference).

Derives steady-state unavailabilities, transition rates/probabilities and
[MTTF, MTTR] tables from raw case reliability data. Replicates (with
citations):

* ``Montecarlo_nsq_single/failprob.m:21-39`` — steady-state unavailability
  U_gen = MTTR/(MTTF+MTTR), U_branch = lambda/(lambda + 8760/duration).
* ``Montecarlo_seq/seqmeantime.m:19-36`` — [MTTF, MTTR] matrix with branch
  MTTF = 8760/lambda.
* ``GeneratingAdequacy/Markov_process.jl:89-94`` — exact one-step transition
  probabilities p01 = 1-exp(-lambda*dt), p10 = 1-exp(-mu*dt), and the
  analytical state-probability evolution pi(t+1) = pi(t) P.
* ``GeneratingAdequacy/parameter_estimation.jl:93-114`` — running estimation
  of lambda/MTTF from observed up-time logs.

All functions are pure and shape-static; host (numpy) inputs are fine since
these are tiny precomputations feeding the samplers.
"""
from __future__ import annotations

import numpy as np

from powersystemsreliabilityassessment.core.cases import CaseData

HOURS_PER_YEAR = 8760.0  # used for rate conversion (failprob.m:31)


def unavailability(case: CaseData) -> np.ndarray:
    """Steady-state component unavailability vector U, [n_comp].

    Generators use U = MTTR/(MTTF+MTTR); branches use U = lambda/(lambda+mu)
    with mu = 8760/duration (failprob.m:21-39).
    """
    u_gen = case.gen_mttr / (case.gen_mttf + case.gen_mttr)
    mu_br = HOURS_PER_YEAR / case.br_dur
    u_br = case.br_lambda / (case.br_lambda + mu_br)
    return np.concatenate([u_gen, u_br])


def mean_times(case: CaseData) -> np.ndarray:
    """[n_comp, 2] matrix of (MTTF, MTTR) hours (seqmeantime.m:19-36)."""
    gen = np.stack([case.gen_mttf, case.gen_mttr], axis=1)
    br = np.stack([HOURS_PER_YEAR / case.br_lambda, case.br_dur], axis=1)
    return np.concatenate([gen, br], axis=0)


def transition_probs(mttf, mttr, dt: float = 1.0):
    """Exact one-step (dt hours) transition probabilities of the two-state
    chain: ``(p_fail, p_repair)`` = (P[up->down], P[down->up]).

    Markov_process.jl:89-94: p01 = 1-exp(-lambda dt), p10 = 1-exp(-mu dt).
    """
    p01 = 1.0 - np.exp(-dt / np.asarray(mttf))
    p10 = 1.0 - np.exp(-dt / np.asarray(mttr))
    return p01, p10


def availability_evolution(mttf: float, mttr: float, steps: int,
                           dt: float = 1.0, p0_down: float = 0.0) -> np.ndarray:
    """Analytical P[down](t) for t = 1..steps via pi(t+1) = pi(t) P.

    Closed form of the two-state chain: P[down](t) = U + (p0_down - U) r^t
    with r = 1 - p01 - p10 and U = p01/(p01+p10); matches the explicit
    matrix-power loop of Markov_process.jl:100-110.
    """
    p01, p10 = transition_probs(mttf, mttr, dt)
    u = p01 / (p01 + p10)
    r = 1.0 - p01 - p10
    t = np.arange(1, steps + 1)
    return u + (p0_down - u) * np.power(r, t)


def steady_state_unavailability(mttf, mttr):
    """U = MTTR / (MTTF + MTTR) (Markov_process.jl:128-130)."""
    return np.asarray(mttr) / (np.asarray(mttf) + np.asarray(mttr))


def estimate_rates(up_durations: np.ndarray, down_durations: np.ndarray):
    """Estimate (MTTF, MTTR, lambda, mu) from field up/down logs.

    parameter_estimation.jl:93-114: lambda_hat = N / sum(TTF).
    """
    mttf = float(np.mean(up_durations))
    mttr = float(np.mean(down_durations))
    return mttf, mttr, 1.0 / mttf, 1.0 / mttr


def running_lambda_estimate(up_durations: np.ndarray) -> np.ndarray:
    """Running estimate lambda_hat(i) = i / sum_{k<=i} TTF_k, [n]."""
    csum = np.cumsum(up_durations)
    n = np.arange(1, len(up_durations) + 1)
    return n / csum
