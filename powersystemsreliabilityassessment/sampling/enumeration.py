"""Exact low-order contingency enumeration (state-space truncation).

The classic state-enumeration method of bulk-system reliability
(Billinton & Allan) that the reference suite lacks entirely: split the
NSQ expectation over i.i.d. Bernoulli component states S into

    E[f(S)] = sum_{|S| <= k} p(S) f(S)      <- enumerated EXACTLY
            + E[f(S) * 1(|S| > k)]          <- deep tail, estimated by MC

Every outage combination up to order ``k`` is evaluated once through the
SAME two-tier DC-OPF evaluator the Monte Carlo uses, weighted by its
exact float64 state probability. The enumerated mass carries zero
sampling variance, so the residual MC only estimates the ``|S| > k``
tail (measured on RTS-24 peak: 3.5x EDNS-variance reduction at k=4,
10.8x at k=5), and the exact part doubles as a
deterministic per-order index decomposition with a certified truncation
bound: index <= exact + P(|S| > k) * worst_case.

Device fit: enumeration is a DENSE batch evaluation problem —
combinations stream through the jitted evaluator in fixed-shape chunks
at the full certificate-screened throughput (the whole k=4 set of
RTS-24 is ~971k states). Weights and accumulation stay on host in
float64.

The NSQ state law here matches sampling/state.py::sample_states exactly:
components with ``always_up`` or U = 0 never fail (mc_sampling.m:40-41
pins the synchronous condenser), so they are excluded from enumeration
and contribute probability factor 1.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from math import comb

import jax
import numpy as np


@dataclasses.dataclass
class ExactPart:
    """Float64 exact contributions of all states with <= order outages."""

    order: int
    n_states: int            # enumerated states (incl. the all-up state)
    mass: float              # P(#down <= order) = sum of enumerated p(S)
    edns_mw: float           # E[DNS * 1(#down <= order)]
    pfail: float             # E[fail * 1(#down <= order)]
    nodal_mw: np.ndarray     # [nb] E[nodal shed * 1(...)]
    comp_fail: np.ndarray    # [n_comp] E[comp down & fail * 1(...)]
    infeasible: int          # enumerated states with no feasible dispatch
    # Certified truncation bounds on the FULL index (tail term bounded by
    # its worst case): edns in [edns_mw, edns_mw + (1-mass)*total_load],
    # pfail in [pfail, pfail + (1-mass)].
    tail_mass: float


def free_components(unavail: np.ndarray, always_up: np.ndarray) -> np.ndarray:
    """Indices of components that can actually fail under the NSQ law."""
    p = np.where(always_up, 0.0, np.asarray(unavail, np.float64))
    return np.nonzero(p > 0.0)[0].astype(np.int32)


def count_states(n_free: int, order: int) -> int:
    return sum(comb(n_free, j) for j in range(order + 1))


@lru_cache(maxsize=64)
def _binom_table(n: int, j: int) -> np.ndarray:
    """[n+1] int64 table of C(c, j) for c = 0..n (nondecreasing in c)."""
    t = np.zeros(n + 1, np.int64)
    for c in range(j, n + 1):
        t[c] = comb(c, j)          # exact ints; C(888,5) ~ 4.5e12 << 2^63
    return t


def unrank_combinations(ranks: np.ndarray, j: int, n: int) -> np.ndarray:
    """Colexicographic unranking (combinatorial number system), vectorized.

    Maps rank r in [0, C(n, j)) to the j-subset {c_1 < ... < c_j} of
    range(n) with r = sum_i C(c_i, i). Each digit is one ``searchsorted``
    over a precomputed binomial table — no Python per-combination loop.
    (itertools.combinations here was the enumeration pre-pass wall:
    minutes of host iterator time for C(71,5), against seconds for
    this unranking.)
    """
    r = np.ascontiguousarray(ranks, np.int64).copy()
    out = np.empty((r.size, j), np.int32)
    for i in range(j, 0, -1):
        table = _binom_table(n, i)
        c = np.searchsorted(table, r, side="right") - 1
        out[:, i - 1] = c
        r -= table[c]
    return out


def _combo_chunks(n_free: int, order: int, chunk: int):
    """Yield (j, combos[int32, c, j]) covering all combinations of each
    order j = 1..order in chunks of at most ``chunk`` rows (colex order,
    ascending indices within each row)."""
    for j in range(1, order + 1):
        total = comb(n_free, j)
        for start in range(0, total, chunk):
            ranks = np.arange(start, min(start + chunk, total),
                              dtype=np.int64)
            yield j, unrank_combinations(ranks, j, n_free)


def state_log_weights(combos: np.ndarray, logit: np.ndarray,
                      log_base: float) -> np.ndarray:
    """log p(S) for combo rows over FREE-component indices (float64)."""
    return log_base + np.sum(logit[combos], axis=1)


def enumerate_exact(sys, compat, ipm, nodal_mode: str, order: int,
                    chunk: int = 65536, max_lp: int | None = None,
                    log_every: int = 0) -> ExactPart:
    """Evaluate every <=order-outage state exactly; fold f64 on host.

    ``sys`` is the built System; evaluation runs through
    ``dcopf.evaluate_states_screened`` in fixed-shape chunks (single
    compile). Chunks whose LP need overflows ``max_lp`` are redone at a
    doubled buffer (new compile, rare), so the result never contains a
    degraded lane silently.
    """
    import jax.numpy as jnp

    from powersystemsreliabilityassessment.engines import dcopf

    unavail = np.asarray(sys.unavail, np.float64)
    always_up = np.asarray(sys.always_up_nsq, bool)
    free = free_components(unavail, always_up)
    n_comp = unavail.shape[0]
    p = unavail[free]
    logit = np.log(p) - np.log1p(-p)                 # per-comp down logit
    log_base = float(np.sum(np.log1p(-p)))           # all-up log-prob

    if max_lp is None:
        # Enumerated low-order states are overwhelmingly benign; 1/16 of
        # the chunk covers the deficit fraction with room to spare, and
        # overflow self-corrects below.
        max_lp = max(chunk // 16, 16)

    def make_step(mlp):
        @jax.jit
        def step(down):
            load = jnp.broadcast_to(sys.load_pd[None, :],
                                    (chunk, sys.n_load))
            res, n_over = dcopf.evaluate_states_screened(
                sys, down, load, mlp, compat, ipm, nodal_mode)
            return (res.dns_mw, res.nodal_mw, res.failure,
                    res.infeasible, n_over)
        return step

    step = make_step(max_lp)

    # Accumulators (float64, host).
    edns = 0.0
    pfail = 0.0
    nodal = np.zeros(sys.n_bus, np.float64)
    comp_fail = np.zeros(n_comp, np.float64)
    mass = 0.0
    n_states = 0
    n_infeasible = 0

    def chunks():
        # Order 0 first — the all-up state is EVALUATED, not assumed
        # zero-shed (load-scaled or degraded systems may shed intact).
        yield 0, np.zeros((1, 0), np.int32)
        yield from _combo_chunks(len(free), order, chunk)

    done = 0
    for j, combos in chunks():
        w = np.exp(state_log_weights(combos, logit, log_base))
        c = combos.shape[0]
        down_np = np.zeros((chunk, n_comp), bool)
        rows = np.repeat(np.arange(c), j)
        down_np[rows, free[combos].ravel()] = True

        while True:
            dns, nod, fail, infeas, n_over = step(jnp.asarray(down_np))
            if int(n_over) == 0:
                break
            max_lp *= 2
            if max_lp > chunk:
                raise RuntimeError("enumeration LP buffer exceeded chunk")
            if log_every:
                print(f"enum: LP buffer overflow; growing to {max_lp}")
            step = make_step(max_lp)

        dns = np.asarray(dns, np.float64)[:c]
        nod = np.asarray(nod, np.float64)[:c]
        fail = np.asarray(fail, np.float64)[:c]
        infeas = np.asarray(infeas, bool)[:c]
        edns += float(w @ dns)
        pfail += float(w @ fail)
        nodal += w @ nod
        wf = w * fail
        np.add.at(comp_fail, free[combos].ravel(),
                  np.repeat(wf, j))
        mass += float(np.sum(w))
        n_states += c
        n_infeasible += int(np.sum(infeas))
        done += c
        if log_every and done % (log_every * chunk) < chunk:
            print(f"enum: {done:,} states, exact EDNS so far {edns:.4f}")

    return ExactPart(order=order, n_states=n_states, mass=mass,
                     edns_mw=edns, pfail=pfail, nodal_mw=nodal,
                     comp_fail=comp_fail, infeasible=n_infeasible,
                     tail_mass=max(1.0 - mass, 0.0))
