"""Analytical capacity-outage probability table (COPT) engines.

Recursive unit-addition convolution on a fixed MW grid, as a ``lax.scan``
over units where each step is a shift-and-add (the reference's per-state
``findfirst``/index lookups become static gathers — XLA-friendly, exact).

Replicates:
* probability convolution with capacity-rounding interpolation
  (``generating_adequacy_assessment.jl:30-107``,
  ``PowerSystemAdequacy.jl:67-111``,
  ``generating_adequacy_comprehensive.jl:34-70``);
* the frequency-extended recursion on cumulative tables
  F_new(X) = p F(X) + q F(X-C) + lambda p [P(X-C) - P(X)]
  (``generating_adequacy_frequency.jl:110-148``);
* LOLE/EUE evaluation against a load curve
  (``generating_adequacy_assessment.jl:113-146``) and LOLE/LOLF/LOLD risk
  from cumulative P/F tables (``generating_adequacy_frequency.jl:155-186``);
* the 7-point discretized-normal load-forecast-uncertainty mixture
  (``generating_adequacy_comprehensive.jl:76-80``).

Grids are static: ``n_points`` must cover total capacity / step + 1.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# 7-step discretized normal: (sigma multiple, probability)
# (generating_adequacy_comprehensive.jl:76-80)
LFU_POINTS = np.array([-3.0, -2.0, -1.0, 0.0, 1.0, 2.0, 3.0])
LFU_PROBS = np.array([0.006, 0.061, 0.242, 0.382, 0.242, 0.061, 0.006])


def grid_points_for(total_capacity: float, step: float) -> int:
    return int(np.ceil(total_capacity / step)) + 1


def _shift(p: jax.Array, k: jax.Array, fill: float = 0.0) -> jax.Array:
    """p shifted right by k grid slots: out[i] = p[i-k] (fill below 0).

    Implemented as a dynamic_slice of a fill-padded copy: the obvious
    gather form (``p[clip(arange - k, 0)]``) has compiled superlinearly
    slowly in grid size on some accelerator backends; the slice form
    compiles in seconds everywhere."""
    n = p.shape[0]
    padded = jnp.concatenate([jnp.full((n,), fill, p.dtype), p])
    k = jnp.clip(k, 0, n)
    return jax.lax.dynamic_slice(padded, (n - k,), (n,))


@partial(jax.jit, static_argnames=("step", "n_points"))
def build_copt(capacities: jax.Array, q: jax.Array, step: float,
               n_points: int) -> jax.Array:
    """Exact-probability COPT: returns P[Outage = i*step] for i < n_points.

    Non-grid-multiple capacities are split between the two adjacent grid
    slots with weights (1-alpha, alpha) — the reference's rounding
    interpolation (generating_adequacy_assessment.jl:91-104).
    """
    probs0 = jnp.zeros((n_points,), capacities.dtype).at[0].set(1.0)

    def add_unit(probs, unit):
        cap, qq = unit
        p = 1.0 - qq
        k_low = jnp.floor(cap / step).astype(jnp.int32)
        alpha = cap / step - k_low.astype(cap.dtype)
        new = (p * probs
               + qq * (1.0 - alpha) * _shift(probs, k_low)
               + qq * alpha * _shift(probs, k_low + 1))
        return new, None

    probs, _ = jax.lax.scan(add_unit, probs0, (capacities, q))
    return probs


@partial(jax.jit, static_argnames=("step", "n_points"))
def build_copt_fd(capacities: jax.Array, q: jax.Array, lam_per_yr: jax.Array,
                  step: float, n_points: int):
    """Frequency & duration COPT on cumulative tables.

    Returns (cum_prob, cum_freq): P[Outage >= i*step] and the cumulative
    frequency F[Outage >= i*step] in occurrences/year. Boundary condition
    P(>= negative) = 1, F(>= negative) = 0
    (generating_adequacy_frequency.jl:93-99). Capacities are convolved at
    the nearest grid multiple (the F&D reference uses exact-multiple grids).
    """
    cum_p0 = jnp.zeros((n_points,), capacities.dtype).at[0].set(1.0)
    # P[Outage >= 0] = 1 everywhere? No: empty system has outage exactly 0,
    # so P[>= 0] = 1 and P[>= x] = 0 for x > 0.
    cum_f0 = jnp.zeros((n_points,), capacities.dtype)

    def add_unit(carry, unit):
        cum_p, cum_f = carry
        cap, qq, lam = unit
        p = 1.0 - qq
        k = jnp.round(cap / step).astype(jnp.int32)
        p_shift = _shift(cum_p, k, fill=1.0)
        f_shift = _shift(cum_f, k, fill=0.0)
        new_p = p * cum_p + qq * p_shift
        new_f = p * cum_f + qq * f_shift + lam * p * (p_shift - cum_p)
        return (new_p, new_f), None

    (cum_p, cum_f), _ = jax.lax.scan(
        add_unit, (cum_p0, cum_f0), (capacities, q, lam_per_yr))
    return cum_p, cum_f


class COPTSummary(NamedTuple):
    suffix_prob: jax.Array   # [pad(n+1)] S0[i] = P[Outage >= i*step]
    suffix_xprob: jax.Array  # [pad(n+1)] S1[i] = E[Outage; Outage >= i*step]
    sentinel: int            # index of the all-zero "beyond the table" slot
    #   (= the unpadded n). The arrays are zero-padded to a 128 multiple
    #   (see summarize); consumers must clip to `sentinel`,
    #   never derive the grid size from the padded array length.


def summarize(probs: jax.Array, step: float) -> COPTSummary:
    x = jnp.arange(probs.shape[0], dtype=probs.dtype) * step
    zero = jnp.zeros((1,), probs.dtype)
    s0 = jnp.concatenate([jnp.cumsum(probs[::-1])[::-1], zero])
    s1 = jnp.concatenate([jnp.cumsum((probs * x)[::-1])[::-1], zero])
    sentinel = probs.shape[0]
    # Pad the lookup tables to a multiple of 128: 1-D gathers from tables of
    # other lengths have compiled pathologically slowly on some accelerator
    # backends. The zero padding coincides with the "beyond the table" sentinel
    # at index n, so clipped lookups are unchanged.
    pad = (-s0.shape[0]) % 128
    if pad:
        z = jnp.zeros((pad,), probs.dtype)
        s0 = jnp.concatenate([s0, z])
        s1 = jnp.concatenate([s1, z])
    return COPTSummary(suffix_prob=s0, suffix_xprob=s1, sentinel=sentinel)


def risk_at_loads(summary: COPTSummary, total_capacity, loads,
                  step: float):
    """(lolp [H], eue_rate [H]) against per-hour loads.

    lolp_h = P[Outage > reserve_h]; eue_rate_h = E[(Outage - reserve_h)+]
    with reserve = total_capacity - load (strict inequality via the
    floor(reserve/step)+1 index, generating_adequacy_assessment.jl:122-141).
    """
    reserve = total_capacity - loads
    idx = jnp.clip(jnp.floor(reserve / step).astype(jnp.int32) + 1, 0,
                   summary.sentinel)
    lolp = summary.suffix_prob[idx]
    eue = summary.suffix_xprob[idx] - reserve * summary.suffix_prob[idx]
    return lolp, eue


@partial(jax.jit, static_argnames=("step",))
def expected_excess(summary: COPTSummary, total_capacity, loads,
                    step: float):
    """sum_h E[(Outage - reserve_h)+] — the ELU energy-demand kernel
    (jitted; see lole_eue for why eager execution is ruinous here)."""
    _, e = risk_at_loads(summary, total_capacity, loads, step)
    return jnp.sum(e)


@partial(jax.jit, static_argnames=("step",))
def lole_eue(probs: jax.Array, step: float, total_capacity, loads):
    """Annual LOLE (h) and EUE (MWh) for an hourly load vector.

    Jitted as a unit: un-jitted eager execution dispatches (and
    compiles) each op as its own mini-executable."""
    s = summarize(probs, step)
    lolp, eue = risk_at_loads(s, total_capacity, loads, step)
    return jnp.sum(lolp), jnp.sum(eue)


@partial(jax.jit, static_argnames=("step",))
def lole_eue_lfu(probs: jax.Array, step: float, total_capacity, loads,
                 lfu_sigma_mw: float):
    """LOLE/EUE under the 7-point load-forecast-uncertainty mixture."""
    s = summarize(probs, step)
    pts = jnp.asarray(LFU_POINTS, probs.dtype)
    ws = jnp.asarray(LFU_PROBS, probs.dtype)

    def one(z, w):
        lolp, eue = risk_at_loads(s, total_capacity, loads + z * lfu_sigma_mw,
                                  step)
        return w * jnp.sum(lolp), w * jnp.sum(eue)

    lo, eu = jax.vmap(one)(pts, ws)
    return jnp.sum(lo), jnp.sum(eu)


def build_copt_np(capacities_mw: np.ndarray, q: np.ndarray,
                  step: float = 1.0) -> np.ndarray:
    """Host-side float64 COPT (same recursion as :func:`build_copt`).

    Used for the sequential study's control-variate means, where the
    expectation must be exact to f64 so it cannot inject bias into the
    adjusted estimator (studies/hl2_seq.py). For integer-MW capacities on
    a 1 MW grid (every RTS fleet) the table is exact — the rounding
    interpolation never triggers.
    """
    caps = np.asarray(capacities_mw, np.float64)
    q = np.asarray(q, np.float64)
    n = int(np.ceil(caps.sum() / step)) + 1
    probs = np.zeros(n)
    probs[0] = 1.0
    for cap, qq in zip(caps, q):
        k_low = int(np.floor(cap / step))
        alpha = cap / step - k_low
        new = (1.0 - qq) * probs
        shifted = np.zeros(n)
        shifted[k_low:] = probs[:n - k_low]
        new += qq * (1.0 - alpha) * shifted
        if alpha > 0.0:
            shifted2 = np.zeros(n)
            shifted2[k_low + 1:] = probs[:n - k_low - 1]
            new += qq * alpha * shifted2
        probs = new
    return probs


def copper_cv_means(capacities_mw: np.ndarray, q: np.ndarray,
                    loads_mw: np.ndarray, thresh_mw: float = 0.0,
                    step: float = 1.0):
    """Exact (f64) means of the copper-sheet control variates.

    Returns ``(mu_eens, mu_lole, eue_h, lolp_h)`` for an hourly load
    vector under the STATIONARY outage distribution:

        eue_h  = E[(Outage - reserve_h)+]        (MWh at 1-hour steps)
        lolp_h = P[Outage > reserve_h - thresh]  (copper deficit > thresh)

    with ``reserve_h = sum(capacities) - loads_mw[h]``. These are the
    exact expectations of the per-hour copper deficit / loss flag that
    the sequential study computes on-device from stationary-start
    timelines (chronological.sample_timeline_stationary) — pass the SAME
    float32-rounded ``loads_mw`` the device uses so the two sides see
    identical load values. Suffix-sum evaluation mirrors
    :func:`risk_at_loads` (strict inequality via floor(r/step)+1,
    generating_adequacy_assessment.jl:122-141) but stays in numpy f64.
    """
    probs = build_copt_np(capacities_mw, q, step)
    n = probs.shape[0]
    x = np.arange(n, dtype=np.float64) * step
    s0 = np.concatenate([np.cumsum(probs[::-1])[::-1], [0.0]])
    s1 = np.concatenate([np.cumsum((probs * x)[::-1])[::-1], [0.0]])
    total = float(np.asarray(capacities_mw, np.float64).sum())
    loads = np.asarray(loads_mw, np.float64)

    reserve = total - loads
    idx = np.clip(np.floor(reserve / step).astype(np.int64) + 1, 0, n)
    eue_h = s1[idx] - reserve * s0[idx]
    # Copper deficit > thresh  <=>  Outage > reserve + thresh.
    r2 = reserve + thresh_mw
    idx2 = np.clip(np.floor(r2 / step).astype(np.int64) + 1, 0, n)
    lolp_h = s0[idx2]
    return float(eue_h.sum()), float(lolp_h.sum()), eue_h, lolp_h


@partial(jax.jit, static_argnames=("step", "hours_per_year"))
def fd_risk(cum_p: jax.Array, cum_f: jax.Array, step: float,
            total_capacity, peak_load, hours_per_year: float = 8760.0):
    """(LOLE h/yr, LOLF occ/yr, LOLD h/occ) at a constant peak load.

    generating_adequacy_frequency.jl:155-186: index of first outage level
    strictly greater than the reserve.
    """
    n = cum_p.shape[0]
    reserve = total_capacity - peak_load
    idx = jnp.clip(jnp.floor(reserve / step).astype(jnp.int32) + 1, 0, n - 1)
    lole = cum_p[idx] * hours_per_year
    lolf = cum_f[idx]
    lold = jnp.where(lolf > 0, lole / lolf, 0.0)
    return lole, lolf, lold
