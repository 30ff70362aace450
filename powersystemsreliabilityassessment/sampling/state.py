"""Non-sequential (state-sampling) Monte Carlo engine.

Replaces ``Montecarlo_nsq_single/mc_sampling.m:24-45`` (rand matrix <
unavailability, sync condenser pinned up) with vectorized counter-based
PRNG over a ``[batch, n_comp]`` block: every batch is derived from a
``fold_in`` of the study key, so runs are deterministic, reproducible and
order-independent across devices (the reference mains are unseeded;
SURVEY.md §4.3).

Note the framework does NOT keep the reference's unique-state dedup
database (nsqMain.m:219-245): on an accelerator, re-evaluating duplicate
states in a dense batch is cheaper than host-side dedup bookkeeping, and
the estimator is identical in expectation (SURVEY.md §7 layer 7).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("batch", "antithetic"))
def sample_states(key: jax.Array, unavail: jax.Array, always_up: jax.Array,
                  batch: int, antithetic: bool = False) -> jax.Array:
    """Draw a batch of component failure indicators (1 = failed).

    Args:
      unavail: [n_comp] steady-state unavailability U.
      always_up: [n_comp] bool — components whose failure is neglected
        (mc_sampling.m:40-41 pins the synchronous condenser).
      antithetic: if True, the second half of the batch uses 1-u of the
        first half's uniforms (variance reduction for the scale-up config).

    Draws use ``jax.random`` (threefry, counter-based): the same seed
    gives the same states on every backend.

    Returns: bool [batch, n_comp].
    """
    n = unavail.shape[0]
    if antithetic:
        half = (batch + 1) // 2
        u = jax.random.uniform(key, (half, n))
        # Trim preserves the requested batch size for odd batches (the
        # last sample is then unpaired — a vanishing perturbation of the
        # variance-reduction pairing, not of the estimator).
        u = jnp.concatenate([u, 1.0 - u], axis=0)[:batch]
    else:
        u = jax.random.uniform(key, (batch, n))
    down = u < unavail[None, :]
    return down & ~always_up[None, :]


@partial(jax.jit, static_argnames=("batch",))
def sample_states_importance(key: jax.Array, unavail: jax.Array,
                             always_up: jax.Array, batch: int,
                             boost: float,
                             boost_mask: jax.Array | None = None,
                             q_override: jax.Array | None = None):
    """Importance-sampled state draw: failure-biased proposal + weights.

    Variance reduction for rare-event regimes the reference's plain MC
    (mc_sampling.m) handles poorly: components are drawn from the
    proposal q_i = min(boost * U_i, 0.5) instead of their true
    unavailability U_i, so multi-outage states appear ~boost^k more
    often; each state carries its exact likelihood ratio

        w = prod_i (U_i/q_i)^x_i ((1-U_i)/(1-q_i))^(1-x_i)

    and every index estimated as a w-weighted mean is unbiased
    (E_q[w f(X)] = E_p[f(X)]). Pinned (always-up) components are fixed
    under both measures, so they contribute factor 1.

    ``boost_mask`` ([n_comp] bool, optional) restricts the boost to a
    subset of components: where the mask is False, q_i = U_i exactly
    (likelihood-ratio factor 1 — those components are sampled from the
    true measure). Use case: capacity-driven rare events at
    transmission scale (case300) want GENERATOR outages boosted while
    branch outages stay at plain rates, so the tier-1 certificate's
    n_out <= woodbury_k eligibility keeps its ~99% closure instead of
    collapsing under boosted multi-branch states.

    ``q_override`` ([n_comp], optional) supplies the proposal rates
    directly (ignoring ``boost``/``boost_mask``): the per-component
    tilt of the cross-entropy adaptive scheme
    (hl2_nsq.calibrate_ce_proposal). Values are clamped to
    [unavail, 0.5] — the proposal never under-samples a component's
    failure (which would put likelihood ratios > 1 on failure events).

    Returns (down bool [batch, n_comp], weight f32 [batch]).
    """
    n = unavail.shape[0]
    if q_override is not None:
        q = jnp.clip(q_override, unavail, jnp.maximum(unavail, 0.5))
    else:
        q = jnp.minimum(boost * unavail, 0.5)
        if boost_mask is not None:
            q = jnp.where(boost_mask, q, unavail)
    q = jnp.where(always_up, 0.0, q)
    p = jnp.where(always_up, 0.0, unavail)
    u = jax.random.uniform(key, (batch, n))
    down = (u < q[None, :]) & ~always_up[None, :]
    # log-space product of per-component ratios. Pinned components AND
    # zero-unavailability components contribute factor 1: with p = q = 0
    # the component never fails under either measure, and leaving the
    # -inf log-ratio in place would turn the (never-taken) failure term
    # into 0 * -inf = NaN through the matmul.
    never = always_up | (unavail <= 0.0)
    safe_q = jnp.maximum(q, 1e-30)
    log_fail = jnp.where(never, 0.0, jnp.log(p / safe_q))
    log_ok = jnp.where(never, 0.0,
                       jnp.log((1.0 - p) / jnp.maximum(1.0 - q, 1e-30)))
    x = down.astype(unavail.dtype)
    logw = x @ log_fail + (1.0 - x) @ log_ok
    return down, jnp.exp(logw)


@partial(jax.jit, static_argnames=("batch",))
def sample_states_mixture(key: jax.Array, unavail: jax.Array,
                          always_up: jax.Array, batch: int,
                          group_masks: jax.Array,
                          boost: float, alpha0: float = 0.5):
    """Defensive-mixture importance sampling over component groups.

    The round-5 event anatomy at case300s
    (results/case300_events.json) shows every deficit event is an
    AREA-CONCENTRATION anomaly: a normal total outage count whose
    generator outages cluster inside one of the (symmetric) areas,
    exceeding the ring import. A product tilt cannot represent "one
    area collapses, I don't know which" — the measured dense/sparse CE
    failures (RESULTS.md) — but a MIXTURE can: with probability
    ``alpha0`` a lane samples from the TRUE measure, else from one of
    K per-group proposals q_k (group k's components boosted
    q_i = min(boost * U_i, 0.5), everything else exact). Each lane
    carries the exact mixture likelihood ratio

        w = p(x) / (alpha0 p(x) + sum_k alpha_g q_k(x)),

    so estimates are unbiased for ANY groups/boost, and the defensive
    plain component bounds every weight by 1/alpha0 — the weight
    degeneracy that killed the dense CE proposal is impossible by
    construction. Group-k collapse events are oversampled ~boost^j
    (j = in-group outages) while carrying O(alpha0^-1 boost^-j)
    weights.

    ``group_masks``: [K, n_comp] bool — typically one row per area's
    generators (``hl2_nsq.gen_area_groups``). Rows may overlap.

    Returns (down bool [batch, n_comp], weight f32 [batch]).

    The reference has no rare-event machinery (plain MC,
    mc_sampling.m:31-47); this targets the composition-anomaly regime
    its flagship large systems live in.
    """
    n = unavail.shape[0]
    K = group_masks.shape[0]
    p = jnp.where(always_up, 0.0, unavail)
    qb = jnp.minimum(boost * unavail, 0.5)
    qb = jnp.maximum(qb, unavail)          # never under-sample failures
    qb = jnp.where(always_up, 0.0, qb)

    km, ku = jax.random.split(key)
    alpha_g = (1.0 - alpha0) / K
    # mixture index per lane: 0 = plain, 1..K = group proposals
    probs = jnp.concatenate([jnp.asarray([alpha0], unavail.dtype),
                             jnp.full((K,), alpha_g, unavail.dtype)])
    m = jax.random.categorical(km, jnp.log(probs), shape=(batch,))
    # lane's boosted-component mask via one-hot matmul (gather-free)
    sel = jax.nn.one_hot(m, K + 1, dtype=unavail.dtype)[:, 1:]  # [B, K]
    lane_boost = sel @ group_masks.astype(unavail.dtype)        # [B, n]
    q_lane = jnp.where(lane_boost > 0.5, qb[None, :], p[None, :])
    u = jax.random.uniform(ku, (batch, n))
    down = (u < q_lane) & ~always_up[None, :]

    # log q_k(x) - log p(x) restricted to group k: two [B,n]@[n,K]
    # matmuls (never/zero-U components contribute exactly 0, same guard
    # as sample_states_importance).
    never = always_up | (unavail <= 0.0)
    d_fail = jnp.where(never, 0.0,
                       jnp.log(jnp.maximum(qb, 1e-30)
                               / jnp.maximum(p, 1e-30)))
    d_ok = jnp.where(never, 0.0,
                     jnp.log(jnp.maximum(1.0 - qb, 1e-30)
                             / jnp.maximum(1.0 - p, 1e-30)))
    gm = group_masks.astype(unavail.dtype)                       # [K, n]
    x = down.astype(unavail.dtype)
    delta = x @ (gm * d_fail[None, :]).T \
        + (1.0 - x) @ (gm * d_ok[None, :]).T                     # [B, K]
    # log w = -logsumexp([log a0, log ag + delta_k]) (ll_p cancels)
    stack = jnp.concatenate(
        [jnp.full((batch, 1), jnp.log(alpha0), unavail.dtype),
         jnp.log(alpha_g) + delta], axis=1)
    logw = -jax.scipy.special.logsumexp(stack, axis=1)
    return down, jnp.exp(logw)
