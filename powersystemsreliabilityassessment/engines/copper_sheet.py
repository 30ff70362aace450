"""HL1 "copper sheet" evaluators: generation vs. load, no network.

Replaces the scalar Julia loops of ``PowerSystemAdequacy.jl``:

* ``run_non_sequential_mc`` (:169-208) — per-sample available capacity vs.
  an 8760-h load sweep. Instead of an O(samples*hours) comparison loop, the
  load curve is sorted once and each sample's LOLE/EUE is an O(log H)
  ``searchsorted`` + suffix-sum lookup — an *exact* reformulation.
* ``run_sequential_mc`` (:214-269) — hourly deficit of a chronological
  capacity series (the series itself comes from
  :mod:`..sampling.chronological`).
* ``calnlc`` frequency counting (Montecarlo_seq/calnlc.m:22-34).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class LoadCurve(NamedTuple):
    """Preprocessed hourly load for O(log H) adequacy lookups."""
    hourly: jax.Array        # [H] original chronological order
    sorted: jax.Array        # [H] ascending
    suffix_sum: jax.Array    # [H+1]; suffix_sum[i] = sum(sorted[i:])

    @staticmethod
    def build(hourly_load) -> "LoadCurve":
        hourly = jnp.asarray(hourly_load)
        s = jnp.sort(hourly)
        suffix = jnp.concatenate(
            [jnp.cumsum(s[::-1])[::-1], jnp.zeros((1,), s.dtype)])
        # Pad the gather table to a multiple of 128 (see
        # engines/copt.py::summarize). Indices never reach the
        # padding (searchsorted <= H < padded length).
        pad = (-suffix.shape[0]) % 128
        if pad:
            suffix = jnp.concatenate(
                [suffix, jnp.zeros((pad,), s.dtype)])
        return LoadCurve(hourly=hourly, sorted=s, suffix_sum=suffix)


def annual_indices_from_capacity(cap: jax.Array, curve: LoadCurve):
    """(lole_hours, eue_mwh) for constant available capacity over the curve.

    Exact: lole = #{h: load_h > cap}, eue = sum over those hours of
    (load_h - cap). Matches PowerSystemAdequacy.jl:186-197 hour sweep.
    The insertion index is a fused compare-and-count rather than a
    binary search (same trick as sampling/chronological.py — a
    per-element searchsorted is gather-bound).
    """
    h = curve.sorted.shape[0]
    idx = jnp.sum((curve.sorted <= cap[..., None]).astype(jnp.int32),
                  axis=-1)
    count = (h - idx).astype(curve.sorted.dtype)
    eue = curve.suffix_sum[idx] - count * cap
    return count, eue


@partial(jax.jit, static_argnames=("batch",))
def nsq_batch(key: jax.Array, capacities: jax.Array, for_rates: jax.Array,
              curve: LoadCurve, batch: int):
    """One NSQ MC batch: sample gen states i.i.d., evaluate the full year.

    Returns per-sample (lole_hours [B], eue [B], cap [B]).
    """
    u = jax.random.uniform(key, (batch, capacities.shape[0]))
    up = u >= for_rates[None, :]
    cap = up.astype(capacities.dtype) @ capacities
    lole, eue = jax.vmap(lambda c: annual_indices_from_capacity(c, curve))(cap)
    return lole, eue, cap


def hourly_deficit(cap_series: jax.Array, hourly_load: jax.Array):
    """Chronological deficit: (lole_hours, eens, deficit_series).

    cap_series: [..., H] available capacity; hourly_load: [H].
    """
    deficit = jnp.maximum(hourly_load - cap_series, 0.0)
    lole = jnp.sum(deficit > 0, axis=-1).astype(cap_series.dtype)
    eens = jnp.sum(deficit, axis=-1)
    return lole, eens, deficit


def count_curtailment_events(flags: jax.Array) -> jax.Array:
    """Number of distinct 0->1 events along the last axis (calnlc.m:22-34),
    including the starts-failed edge case."""
    f = flags.astype(jnp.int32)
    rises = jnp.sum((f[..., 1:] - f[..., :-1]) == 1, axis=-1)
    return rises + f[..., 0]


def capacity_series_from_down(down: jax.Array, capacities: jax.Array):
    """Available capacity series from a DOWN indicator [..., n_gen, H]."""
    up = 1.0 - down.astype(capacities.dtype)
    return jnp.einsum("...gh,g->...h", up, capacities)
