"""Sequential (chronological) state-duration sampling.

Replaces the reference's per-component while-loop "next event" simulation
(``Montecarlo_seq/seq_mcsampling.m:44-75``: alternate exponential TTF/TTR
draws, ``round`` for up-times, ``ceil`` for repair-times) with a fully
vectorized fixed-draw-count construction suitable for XLA:

1.  draw a static number K of (up, down) duration pairs per component;
2.  interleave and prefix-sum them into event-time boundaries ``[2K]``;
3.  a component is DOWN at (0-based) hour ``h`` iff the number of
    boundaries <= h is odd (the ``searchsorted(..., side="right")``
    parity, but computed as a broadcast compare-and-count: the per-hour
    binary search is gather-bound, while the fused compare+reduce is
    one elementwise pass with bit-identical output).

Step 3 reproduces the reference's integer interval semantics exactly
(down hours are ``[t, t + ttr)`` after an up-time ending at ``t``). K is
chosen so the probability of the boundary sequence not covering the horizon
is < 1e-6 (the tail beyond the last drawn event is treated as UP; with the
default margin this is a < 1e-6 perturbation — the reference's while-loop
has no such truncation but is not shape-static).

The alternative per-hour Markov-transition sampler used by the educational
modules (Markov_process.jl:172-195) lives in :mod:`.markov`.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def default_num_draws(mttf: np.ndarray, mttr: np.ndarray, hours: int) -> int:
    """Static per-run draw count K: mean cycles + 8 sigma + slack."""
    cycle = np.asarray(mttf, dtype=np.float64) + np.asarray(mttr, np.float64)
    n_mean = hours / cycle
    k = n_mean + 8.0 * np.sqrt(np.maximum(n_mean, 1.0)) + 8.0
    return int(np.ceil(k.max()))


@partial(jax.jit, static_argnames=("hours", "n_draws", "quantize"))
def sample_timeline(key: jax.Array, mttf: jax.Array, mttr: jax.Array,
                    hours: int, n_draws: int,
                    quantize: bool = True) -> jax.Array:
    """One chronological realization for all components.

    Returns bool [n_comp, hours], True = DOWN (the reference convention).
    ``quantize=True`` applies the reference's round(TTF)/ceil(TTR) integer
    quantization (seq_mcsampling.m:369-376); ``False`` keeps continuous
    event times (hour state = state at the start of the hour).
    """
    n = mttf.shape[0]
    ku, kd = jax.random.split(key)
    uu = jax.random.uniform(ku, (n, n_draws), minval=1e-12, maxval=1.0)
    ud = jax.random.uniform(kd, (n, n_draws), minval=1e-12, maxval=1.0)
    ttf = -mttf[:, None] * jnp.log(uu)
    ttr = -mttr[:, None] * jnp.log(ud)
    if quantize:
        ttf = jnp.round(ttf)
        ttr = jnp.ceil(ttr)

    # Interleave up/down durations -> [n, 2K] event boundaries.
    durations = jnp.stack([ttf, ttr], axis=2).reshape(n, 2 * n_draws)
    bounds = jnp.cumsum(durations, axis=1)

    # DOWN at hour h iff #(bounds <= h) is odd — the searchsorted parity,
    # as a fused broadcast compare+count (see module docstring). numpy
    # arange: a jnp constant would be created eagerly at trace time
    # (a device dispatch) and fetched back at lowering.
    hour_idx = np.arange(hours, dtype=bounds.dtype)
    cnt = jnp.sum((bounds[:, :, None] <= hour_idx[None, None, :])
                  .astype(jnp.int32), axis=1)
    return (cnt % 2) == 1


@partial(jax.jit, static_argnames=("hours", "n_draws", "batch", "quantize"))
def sample_timeline_batch(key: jax.Array, mttf: jax.Array, mttr: jax.Array,
                          hours: int, n_draws: int, batch: int,
                          quantize: bool = True) -> jax.Array:
    """[batch, n_comp, hours] independent yearly realizations."""
    keys = jax.random.split(key, batch)
    return jax.vmap(lambda k: sample_timeline(
        k, mttf, mttr, hours, n_draws, quantize))(keys)


@partial(jax.jit, static_argnames=("hours", "n_draws"))
def sample_timeline_stationary(key: jax.Array, mttf: jax.Array,
                               mttr: jax.Array, hours: int,
                               n_draws: int) -> jax.Array:
    """Stationary-start chronological realization (continuous dwells).

    The initial state is drawn from the stationary distribution,
    ``down0 ~ Bernoulli(U)`` with ``U = mttr/(mttf+mttr)``; by the
    memorylessness of the exponential dwells the residual dwell of a
    component observed at its stationary phase is again exponential with
    the full mean, so the state at EVERY hour is exactly ``Bernoulli(U)``
    — the marginal never leaves the stationary law. The reference starts
    all-up (seq_mcsampling.m:44-55), so its early hours under-count
    failures with time constant ~= MTTR (~50-150 h) — during the RTS-79
    winter peak. This per-hour exactness is the prerequisite for the
    copper-sheet control variate (studies/hl2_seq.py,
    ``control_variate=True``): the analytical COPT expectation equals the
    sampled copper-deficit mean at every hour.
    """
    k0, k1 = jax.random.split(key)
    u = mttr / (mttf + mttr)
    down0 = jax.random.uniform(k0, mttf.shape) < u
    return sample_timeline_from_state(k1, down0, mttf, mttr, hours,
                                      n_draws)


@partial(jax.jit, static_argnames=("hours", "n_draws", "antithetic"))
def sample_timeline_from_state(key: jax.Array, down0: jax.Array,
                               mttf: jax.Array, mttr: jax.Array,
                               hours: int, n_draws: int,
                               antithetic: bool = False) -> jax.Array:
    """Chronological realization STARTING from a given component state.

    ``down0`` [n_comp] bool: True = the component is DOWN at hour 0. By
    the memorylessness of the exponential dwell times, the residual
    up-time (resp. repair-time) of a component observed mid-dwell is
    again exponential with the same mean, so a trajectory can be cloned
    at any hour from its binary state vector alone — the primitive that
    makes multilevel splitting (studies/hl2_seq_split.py) exact. For a
    DOWN component the first drawn duration is a repair time, so the
    interleaving swaps per component; the parity rule gains a +down0
    offset (DOWN at hour h iff #(bounds <= h) + down0 is odd... i.e.
    count is EVEN while still inside the first, down, dwell).

    Continuous durations only (``quantize`` would break memorylessness —
    the residual of a rounded dwell is not exchangeable with a fresh
    rounded draw), which matches the splitting study's convention.

    ``antithetic=True`` reflects every dwell uniform u -> 1-u; a clone
    pair (key, flag=False/True) is then negatively correlated in any
    outcome monotone in the dwell times (tail ENS is: longer up-times =>
    less shed), reducing the variance of the pair average below the
    independent-pair value while each member stays exactly distributed.
    """
    n = mttf.shape[0]
    ka, kb = jax.random.split(key)
    ua = jax.random.uniform(ka, (n, n_draws), minval=1e-12, maxval=1.0)
    ub = jax.random.uniform(kb, (n, n_draws), minval=1e-12, maxval=1.0)
    if antithetic:
        # 1-u stays inside (0, 1-1e-12]; clamp the log argument's floor
        # to keep exact distributional symmetry with the plain draw.
        ua = jnp.maximum(1.0 - ua, 1e-12)
        ub = jnp.maximum(1.0 - ub, 1e-12)
    # First dwell mean: mttr where starting DOWN, mttf where starting UP;
    # then alternate.
    m_first = jnp.where(down0, mttr, mttf)
    m_second = jnp.where(down0, mttf, mttr)
    d_first = -m_first[:, None] * jnp.log(ua)
    d_second = -m_second[:, None] * jnp.log(ub)
    durations = jnp.stack([d_first, d_second], axis=2).reshape(
        n, 2 * n_draws)
    bounds = jnp.cumsum(durations, axis=1)
    hour_idx = np.arange(hours, dtype=bounds.dtype)
    cnt = jnp.sum((bounds[:, :, None] <= hour_idx[None, None, :])
                  .astype(jnp.int32), axis=1)
    return ((cnt + down0[:, None].astype(jnp.int32)) % 2) == 1
