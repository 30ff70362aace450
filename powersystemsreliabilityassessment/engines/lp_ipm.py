"""Batched box-constrained LP solver: fixed-iteration Mehrotra
predictor-corrector primal-dual interior-point method.

Solves ``min c'x  s.t.  A x = b,  l <= x <= u`` for dense A. This replaces
the reference's per-state MATPOWER MIPS interior-point DC-OPF solves
(``nsqMain.m:185-186`` option ``OPF_ALG_DC=200``; invoked from
``mc_simulation.m:41`` / ``seq_mcsimulation.m:462``) with an
accelerator-friendly formulation: fixed iteration count (no data-dependent
control flow), static shapes, dense normal-equation Cholesky — all of which
``vmap`` cleanly over a scenario batch axis as batched matmuls.

float32 robustness (accelerators run f64 far slower, or not at all): a textbook
Mehrotra loop run in f32 corrupts primal feasibility in its last iterations —
once the complementarity products approach f32 roundoff, the Newton direction
no longer satisfies ``A dx = rp`` to useful accuracy and near-unit steps walk
the iterate off the equality manifold. Three measures keep it sound:

1. iterate freezing: once the average complementarity ``mu`` drops below
   ``mu_tol`` the lane stops moving (shape-static analog of an early exit);
   ``mu_tol`` is chosen above the f32 destruction zone — the duality gap
   ``~2n*mu`` it implies is far below the reference's 0.1 MW DNS noise
   floor, so nothing of statistical relevance is lost;
2. best-iterate tracking: the returned solution is the iterate with the
   lowest ``mu + ||rp||_inf`` score ever visited, so late noisy steps can
   only be ignored, never harm;
3. a single final projection onto ``Ax = b`` (Cholesky of ``A A' + delta I``,
   factorized once) polishes primal feasibility to f32 roundoff.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from powersystemsreliabilityassessment.utils.config import IPMConfig


class LPSolution(NamedTuple):
    x: jax.Array          # [n] primal solution
    objective: jax.Array  # scalar c'x
    primal_residual: jax.Array  # scalar ||Ax-b||_inf
    duality_gap: jax.Array      # scalar complementarity measure mu


def _pos(a, eps=1e-12):
    return jnp.maximum(a, eps)


def solve_box_lp(c, A, b, l, u, cfg: IPMConfig = IPMConfig()) -> LPSolution:
    """Solve one LP instance. All args are jnp arrays; vmap for batches."""
    dtype = jnp.dtype(cfg.dtype)
    c, A, b = c.astype(dtype), A.astype(dtype), b.astype(dtype)
    l, u = l.astype(dtype), u.astype(dtype)
    n = c.shape[0]
    m = b.shape[0]

    width = u - l
    margin = 1e-9 * _pos(width)
    delta = np.asarray(cfg.regularization, dtype)
    tau = np.asarray(cfg.tau, dtype)
    eye_m = np.eye(m, dtype=dtype)

    def equilibrated_chol(M):
        """Symmetric Jacobi scaling + Cholesky: float32 survives the wide
        dynamic range of the late-phase normal matrix only after its rows
        and columns are rescaled to unit diagonal. If the factorization
        still breaks down (returns NaN — jnp.linalg.cholesky never raises),
        the downstream non-finite-step guard freezes the lane at its
        best-so-far iterate; a fallback refactorization is NOT worth it —
        batched Cholesky is the solver's single most expensive op, and
        under vmap any per-lane retry would be paid by every lane."""
        s = jax.lax.rsqrt(jnp.maximum(jnp.diagonal(M), 1e-30))
        Ms = M * s[:, None] * s[None, :]
        return jnp.linalg.cholesky(Ms + delta * eye_m), s

    def chol_solve(chol_s, rhs):
        chol, s = chol_s
        return s * jax.scipy.linalg.cho_solve((chol, True), s * rhs)

    # Constant-through-iterations factorization for primal re-projection.
    chol_aat = equilibrated_chol(A @ A.T)

    def project(x):
        """Project x onto the equality manifold Ax = b."""
        return x + A.T @ chol_solve(chol_aat, b - A @ x)

    # Interior start: box midpoint.
    x0 = 0.5 * (l + u)
    y0 = jnp.zeros_like(b)
    z0 = jnp.ones_like(c)

    def newton_step(d, sl, su, zl, zu, rd, rp, rcl, rcu, chol):
        """Solve the KKT system given a prefactorized normal matrix."""
        rhat = rd - rcl / sl + rcu / su          # [n]
        rhs = rp + A @ (rhat / d)                # [m]
        dy = chol_solve(chol, rhs)
        dx = (A.T @ dy - rhat) / d
        dzl = (rcl - zl * dx) / sl
        dzu = (rcu + zu * dx) / su
        return dx, dy, dzl, dzu

    def max_step(sl, su, zl, zu, dx, dzl, dzu):
        """Fraction-to-boundary step lengths (primal, dual)."""
        big = np.asarray(1e30, dtype)
        ap = jnp.minimum(
            jnp.min(jnp.where(dx < 0, -sl / jnp.minimum(dx, -1e-30), big)),
            jnp.min(jnp.where(dx > 0, su / jnp.maximum(dx, 1e-30), big)),
        )
        ad = jnp.minimum(
            jnp.min(jnp.where(dzl < 0, -zl / jnp.minimum(dzl, -1e-30), big)),
            jnp.min(jnp.where(dzu < 0, -zu / jnp.minimum(dzu, -1e-30), big)),
        )
        return jnp.minimum(tau * ap, 1.0), jnp.minimum(tau * ad, 1.0)

    def metrics(x, y, zl, zu):
        sl = _pos(x - l)
        su = _pos(u - x)
        rp = b - A @ x
        mu = (jnp.dot(sl, zl) + jnp.dot(su, zu)) / (2 * n)
        return sl, su, rp, mu

    def body(_, state):
        x, y, zl, zu, done, best = state
        sl, su, rp, mu = metrics(x, y, zl, zu)
        rd = c - A.T @ y - zl + zu

        # Best-iterate bookkeeping.
        score = mu + jnp.max(jnp.abs(rp))
        best_score, bx = best
        better = score < best_score
        best = (jnp.where(better, score, best_score),
                jnp.where(better, x, bx))

        done = done | (mu < cfg.mu_tol)

        d = jnp.clip(zl / sl + zu / su, 1e-6, 1e10)
        # Gram form G G' (G = A sqrt(1/d)) is PSD by construction in f32 —
        # the asymmetric product (A/d)A' can acquire tiny negative
        # eigenvalues that break Cholesky.
        G = A * jax.lax.rsqrt(d)[None, :]
        chol = equilibrated_chol(G @ G.T)

        # Two-phase strategy. Early (mu large): Mehrotra predictor-corrector
        # for fast progress. Late (mu < center_tol): plain damped centering
        # steps (sigma = 1/2, fraction-to-boundary 0.9, no second-order
        # term) — in float32 the Mehrotra correction turns into noise once
        # complementarity products near roundoff and the aggressive steps
        # make the iterate explode; centering converges linearly and stays
        # stable until the freeze threshold.
        centering = mu < cfg.center_tol

        # Affine (predictor) direction: sigma = 0.
        dxa, dya, dzla, dzua = newton_step(
            d, sl, su, zl, zu, rd, rp, -sl * zl, -su * zu, chol)
        apa, ada = max_step(sl, su, zl, zu, dxa, dzla, dzua)
        mu_aff = (jnp.dot(sl + apa * dxa, zl + ada * dzla)
                  + jnp.dot(su - apa * dxa, zu + ada * dzua)) / (2 * n)
        sigma = jnp.where(centering, 0.5,
                          jnp.clip((mu_aff / _pos(mu)) ** 3, 0.0, 1.0))
        gate = jnp.where(centering, 0.0, 1.0)

        # Corrector direction (second-order term gated off when centering).
        rcl = sigma * mu - sl * zl - gate * dxa * dzla
        rcu = sigma * mu - su * zu + gate * dxa * dzua
        dx, dy, dzl, dzu = newton_step(
            d, sl, su, zl, zu, rd, rp, rcl, rcu, chol)
        ap, ad = max_step(sl, su, zl, zu, dx, dzl, dzu)
        damp = jnp.where(centering, 0.9, 1.0)
        ap = damp * ap
        ad = damp * ad

        xn = jnp.clip(x + ap * dx, l + margin, u - margin)
        yn = y + ad * dy
        zln = _pos(zl + ad * dzl)
        zun = _pos(zu + ad * dzu)

        # A non-finite step is terminal: the state would be unchanged, so
        # the same step would fail forever — keep the best iterate instead.
        finite = (jnp.all(jnp.isfinite(xn)) & jnp.all(jnp.isfinite(yn))
                  & jnp.all(jnp.isfinite(zln)) & jnp.all(jnp.isfinite(zun)))
        keep = done | ~finite
        done = done | ~finite
        x = jnp.where(keep, x, xn)
        y = jnp.where(keep, y, yn)
        zl = jnp.where(keep, zl, zln)
        zu = jnp.where(keep, zu, zun)
        return (x, y, zl, zu, done, best)

    best0 = (jnp.asarray(jnp.inf, dtype), x0)
    state = (x0, y0, z0, z0, jnp.zeros((), bool), best0)
    x, y, zl, zu, _, best = jax.lax.fori_loop(0, cfg.iterations, body, state)

    # Final candidate vs. best-ever iterate, then one feasibility polish.
    _, _, rp_f, mu_f = metrics(x, y, zl, zu)
    score_f = mu_f + jnp.max(jnp.abs(rp_f))
    best_score, bx = best
    x = jnp.where(score_f <= best_score, x, bx)
    x = jnp.clip(project(x), l, u)

    # Crossover polish: the frozen f32 iterate carries a small positive
    # duality gap (it is interior). Snap variables near their bounds onto
    # them, re-solve the remaining degrees of freedom as a weighted
    # least-squares toward the equality constraints, and accept the result
    # only if it is feasible and does not increase the objective. This
    # recovers the exact optimal face in the typical case and can never
    # make the solution worse.
    snap_tol = 1e-3 * width
    at_l = (x - l) < snap_tol
    at_u = (u - x) < snap_tol
    target = jnp.where(at_l, l, jnp.where(at_u, u, x))
    w = jnp.where(at_l | at_u, 1e2, 1e-4)
    H = A.T @ A + jnp.diag(w)
    sH = jax.lax.rsqrt(jnp.maximum(jnp.diagonal(H), 1e-30))
    cholH = jnp.linalg.cholesky(H * sH[:, None] * sH[None, :]
                                + 1e-7 * np.eye(n, dtype=dtype))
    rhs = A.T @ b + w * target
    xp = sH * jax.scipy.linalg.cho_solve((cholH, True), sH * rhs)
    xp = jnp.clip(project(xp), l, u)
    ok = (jnp.all(jnp.isfinite(xp))
          & (jnp.max(jnp.abs(A @ xp - b)) <= jnp.max(jnp.abs(A @ x - b)) + 1e-5)
          & (jnp.dot(c, xp) <= jnp.dot(c, x)))
    x = jnp.where(ok, xp, x)

    rp = b - A @ x
    sl = _pos(x - l)
    su = _pos(u - x)
    mu = (jnp.dot(sl, zl) + jnp.dot(su, zu)) / (2 * n)
    return LPSolution(
        x=x,
        objective=jnp.dot(c, x),
        primal_residual=jnp.max(jnp.abs(rp)),
        duality_gap=mu,
    )


@partial(jax.jit, static_argnames=("cfg",))
def solve_box_lp_batch(c, A, b, l, u, cfg: IPMConfig = IPMConfig()):
    """vmapped solver: every argument carries a leading batch axis."""
    return jax.vmap(lambda cc, AA, bb, ll, uu:
                    solve_box_lp(cc, AA, bb, ll, uu, cfg))(c, A, b, l, u)
