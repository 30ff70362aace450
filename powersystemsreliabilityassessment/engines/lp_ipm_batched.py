"""Batched interior-point LP solver (the evaluator's production path).

Same algorithm and safeguards as :mod:`.lp_ipm` (Mehrotra predictor-
corrector with late-phase centering, iterate freezing, best-iterate
tracking, crossover polish) but written with an explicit leading batch
axis instead of ``vmap``, so the dense linear algebra runs as batched
XLA factorizations (``jnp.linalg.cholesky`` up to ``_BLOCKED_MAX_M``,
the all-matmul blocked factor of :mod:`..ops.xla_chol` beyond).

The crossover polish solves ``(W + A'A) x = rhs`` with diagonal W via the
Woodbury identity, so the only factorizations anywhere are m x m (62 for
RTS-24):
    (W + A'A)^-1 = W^-1 - W^-1 A' (I_m + A W^-1 A')^-1 A W^-1.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from powersystemsreliabilityassessment.utils.config import IPMConfig


class LPBatchSolution(NamedTuple):
    x: jax.Array                # [B, n]
    objective: jax.Array        # [B]
    primal_residual: jax.Array  # [B]
    duality_gap: jax.Array      # [B]


def _pos(a, eps=1e-12):
    return jnp.maximum(a, eps)


def _merge_lanes(new: LPBatchSolution, old: LPBatchSolution
                 ) -> LPBatchSolution:
    """Per-lane keep-the-better merge across solver passes: feasibility
    and duality-gap trust first (heavy penalty past the healthy bands),
    then objective — so well-converged lanes can never regress under a
    restart.

    The gap term (round 4) keeps the merge consistent with the
    evaluator's trust score (rp + 2n*gap): without it, a feasible but
    SUBOPTIMAL candidate (small rp, large gap — e.g. a cold rescue
    pass that converged to the wrong basin, +6.5 MW on the case300
    stress lane 82) outranked a near-optimal jammed iterate the guard
    almost trusts. The 1e-3 deadband keeps healthy gaps (2n*mu ~ 3e-4
    at mu_tol) from perturbing pure-objective ordering."""
    n = new.x.shape[-1]
    pen = lambda s: (s.objective
                     + 1e4 * (jnp.maximum(s.primal_residual - 3e-4, 0.0)
                              + jnp.maximum(2 * n * s.duality_gap - 1e-3,
                                            0.0)))
    take_new = pen(new) < pen(old)
    pick = lambda a_new, a_old: jnp.where(
        take_new[:, None] if a_new.ndim == 2 else take_new, a_new, a_old)
    return LPBatchSolution(
        x=pick(new.x, old.x),
        objective=pick(new.objective, old.objective),
        primal_residual=pick(new.primal_residual, old.primal_residual),
        duality_gap=pick(new.duality_gap, old.duality_gap))


# Systems up to this size factor the dense [B, m, m] normal matrix with
# XLA's batched Cholesky; larger ones (case300 scale, m ~ 792) take the
# structured block-Schur operator and the all-matmul blocked factor.
_BLOCKED_MAX_M = 336


def _make_chol_ops(m: int):
    """Returns (factor, solve) for [B, m, m] SPD systems of size m."""
    if m > _BLOCKED_MAX_M:
        # Large-m path (case300 scale, m ~ 792): all-matmul blocked
        # Cholesky + explicit blocked L^-1 (ops/xla_chol.py). The IPM
        # pays ~12 single-rhs (m-step sequential) solves per iteration;
        # with the explicit inverse every solve is two batched matvecs.
        # Numerics ladder unchanged from the prior jnp.linalg.cholesky
        # revision: the f32 factor of the barrier-weighted normal matrix
        # stalls Newton directions at mu ~ 1e-4 (8-60 MW hidden DNS
        # errors vs the HiGHS f64 oracle, scripts/parity_case300.py), so
        # two iterative-refinement steps against the RETAINED scaled
        # matrix restore direction quality; the explicit inversion's
        # extra rounding (~cond(L) vs substitution) rides the same
        # refinement + best-iterate + quality-guard + escalation net.
        from powersystemsreliabilityassessment.ops import xla_chol

        def factor(M):
            return (xla_chol.factor(M), M)

        def solve(FM, r):
            F, M = FM
            dy = xla_chol.solve(F, r)
            for _ in range(2):
                dy = dy + xla_chol.solve(
                    F, r - jnp.einsum("bij,bj->bi", M, dy))
            return dy
    else:
        def factor(M):
            return jnp.linalg.cholesky(M)

        def solve(L, r):
            return jax.vmap(lambda LL, rr: jax.scipy.linalg.cho_solve(
                (LL, True), rr))(L, r)
    return factor, solve



def _schur_solvers(mv_fn, mtv_fn, schur_factor, schur_solve, delta):
    """(factor, solve) pair over gram-convention weights for the
    block-Schur structured path: factor(w, ridge) builds the two-block
    inverse; solve refines the single substitution pass against the
    MATRIX-FREE operator A diag(w) A' + ridge*I — removing the explicit
    inverses' f32 rounding and the per-block equilibration ridge, so
    accuracy matches the dense path's refined Cholesky."""
    def nfactor(w, ridge: float = 0.0):
        return (schur_factor(w, ridge, delta), w, ridge)

    def nsolve(F3, rhs):
        F, w, ridge = F3

        def apply_n(v):
            out = mv_fn(w * mtv_fn(v))
            return out + ridge * v if ridge else out

        # Keep-best across refinement iterates: at extreme barrier-weight
        # spans (late-IPM d in [1e-6, 1e10]) the refinement can DIVERGE
        # — the factor's f32 error is no longer a contraction — and a
        # diverged direction poisons the whole lane. Never return an
        # iterate with a worse residual than the best seen (same guard
        # as the dense path's refined solve).
        dy = schur_solve(F, rhs)
        best_dy = dy
        best_rn = jnp.max(jnp.abs(rhs - apply_n(dy)), axis=1)
        for _ in range(2):
            dy = dy + schur_solve(F, rhs - apply_n(dy))
            rn = jnp.max(jnp.abs(rhs - apply_n(dy)), axis=1)
            better = rn < best_rn
            best_dy = jnp.where(better[:, None], dy, best_dy)
            best_rn = jnp.minimum(rn, best_rn)
        return best_dy

    return nfactor, nsolve


def polish_box_lp(state, c, b, l, u, cfg: IPMConfig, mv_fn, mtv_fn,
                  gram_fn, schur=None) -> LPBatchSolution:
    """Shared post-iteration polish for the batched IPM variants.

    ``state`` is the loop-carried iterate (x, y, zl, zu, best_score,
    best_x); the constraint operator is supplied abstractly:
    ``mv_fn(v) -> A v``, ``mtv_fn(y) -> A' y``, ``gram_fn(w) ->
    A diag(w) A'``. Steps (identical for the materialized-A and the
    structured/fused paths): best-iterate selection, primal
    re-projection onto Ax=b, Woodbury crossover snap toward the active
    bounds with a monotonicity acceptance test, and the final
    residual/gap report.
    """
    dtype = jnp.dtype(cfg.dtype)
    x, y, zl, zu, best_score, best_x = state
    B, n = x.shape
    m = b.shape[1]

    factor, chol_solve = _make_chol_ops(m)
    delta = np.asarray(cfg.regularization, dtype)
    eye_m = np.eye(m, dtype=dtype)  # numpy: no trace-time device constant

    def bdot(p, q):
        return jnp.sum(p * q, axis=-1)

    def equilibrated_chol(M):
        diag = jnp.diagonal(M, axis1=1, axis2=2)
        s = jax.lax.rsqrt(jnp.maximum(diag, 1e-30))
        Ms = M * s[:, :, None] * s[:, None, :] + delta * eye_m
        return factor(Ms), s

    def eq_solve(chol_s, rhs):
        chol, s = chol_s
        return s * chol_solve(chol, s * rhs)

    if schur is not None:
        nfactor, fsolve = _schur_solvers(mv_fn, mtv_fn, *schur, delta)
        chol_aat = nfactor(jnp.ones_like(x))
    else:
        fsolve = eq_solve
        chol_aat = equilibrated_chol(gram_fn(jnp.ones_like(x)))

    def project(xv):
        return xv + mtv_fn(fsolve(chol_aat, b - mv_fn(xv)))

    width = u - l

    # Final candidate vs best-ever, then one projection polish.
    sl = _pos(x - l)
    su = _pos(u - x)
    rp_f = b - mv_fn(x)
    mu_f = (bdot(sl, zl) + bdot(su, zu)) / (2 * n)
    score_f = mu_f + jnp.max(jnp.abs(rp_f), axis=-1)
    x = jnp.where((score_f <= best_score)[:, None], x, best_x)
    x = jnp.clip(project(x), l, u)

    # Crossover polish via Woodbury (only m x m factorizations):
    # (W + A'A)^-1 rhs = W^-1 rhs - W^-1 A' (I + A W^-1 A')^-1 A W^-1 rhs
    snap_tol = 1e-3 * width
    at_l = (x - l) < snap_tol
    at_u = (u - x) < snap_tol
    target = jnp.where(at_l, l, jnp.where(at_u, u, x))
    w = jnp.where(at_l | at_u, 1e2, 1e-4)
    rhs = mtv_fn(b) + w * target
    winv = 1.0 / w
    if schur is not None:
        cholK = nfactor(winv, 1.0)
    else:
        cholK = equilibrated_chol(gram_fn(winv) + eye_m)
    t1 = winv * rhs
    t2 = fsolve(cholK, mv_fn(t1))
    xp = t1 - winv * mtv_fn(t2)
    xp = jnp.clip(project(xp), l, u)
    ok = (jnp.all(jnp.isfinite(xp), axis=-1)
          & (jnp.max(jnp.abs(mv_fn(xp) - b), axis=-1)
             <= jnp.max(jnp.abs(mv_fn(x) - b), axis=-1) + 1e-5)
          & (bdot(c, xp) <= bdot(c, x)))
    x = jnp.where(ok[:, None], xp, x)

    rp = b - mv_fn(x)
    sl = _pos(x - l)
    su = _pos(u - x)
    mu = (bdot(sl, zl) + bdot(su, zu)) / (2 * n)
    # Rigorous weak-duality certificate (round 4): for ANY dual y the
    # Lagrangian box dual g(y) = b'y + sum_j min(r_j l_j, r_j u_j) with
    # r = c - A'y lower-bounds the optimum, so c'x - g(y) bounds the
    # true objective error of x — no complementarity assumption, unlike
    # the 2n*mu surrogate, which over-flags lanes whose PRIMAL is
    # exactly right but whose multipliers went stale through the
    # crossover snap (observed: the case300 stress suite's one
    # guard-tripped lane scored 6.8e-2 while the f64 oracle put its DNS
    # within 0.03 MW). The reported gap is the min of both bounds: the
    # weak-duality term passing is a proof; the mu term passing is the
    # status quo. Cost: one A'y + O(n) reductions per lane.
    r = c - mtv_fn(y)
    gap_weak = (bdot(c, x) - bdot(b, y)
                - jnp.sum(jnp.minimum(r * l, r * u), axis=-1))
    # The weak-duality bound above is rigorous only for primal-FEASIBLE
    # x; for x with residual rp the objective can sit below g(y) by up
    # to |y|'|rp| (c'x = y'Ax + r'x = y'b - y'rp + r'x). Add that
    # cross-term so the certificate never under-reports a lane whose
    # rp sits inside the acceptance band but whose duals are large
    # (advisor r4 finding; keeps gap <= old mu surrogate when rp ~ 0).
    gap_weak = gap_weak + jnp.sum(jnp.abs(y) * jnp.abs(rp), axis=-1)
    gap = jnp.minimum(mu, _pos(gap_weak) / (2 * n))
    return LPBatchSolution(
        x=x,
        objective=bdot(c, x),
        primal_residual=jnp.max(jnp.abs(rp), axis=-1),
        duality_gap=gap,
    )


class LinOps(NamedTuple):
    """Abstract batched constraint operator for the box-LP core.

    Everything the IPM needs from ``A`` as closures, so structured
    constraint matrices (the DC-OPF blocks: one-hot scatters, branch
    incidence, diagonals — see ``dcopf.make_dc_linops``) never have to
    materialize a [B, m, n] tensor. ``normal`` is kept separate from
    ``gram`` so the dense path can preserve its historical symmetric
    square-root rounding exactly (golden pins).
    """
    mv: object        # v [B,n] -> A v       [B,m]
    mtv: object       # y [B,m] -> A' y      [B,n]
    gram: object      # w [B,n] -> A diag(w) A'     [B,m,m]
    normal: object    # d [B,n] -> A diag(1/d) A'   [B,m,m]
    take: object      # idx [k] -> LinOps over the idx lanes
    # Optional block-Schur factorization of A diag(w) A' + ridge*I for
    # structured A (see dcopf.make_dc_linops): factor(w, ridge, delta)
    # -> opaque F; solve(F, r [B,m]) -> one UNrefined substitution pass
    # (the IPM core refines against the matrix-free operator). None on
    # dense operators; used by the large-m path when present.
    schur_factor: object = None
    schur_solve: object = None


def dense_linops(A) -> LinOps:
    """LinOps over an explicit [B, m, n] constraint tensor."""
    At = jnp.swapaxes(A, 1, 2)

    def mv(v):
        return jnp.einsum("bmn,bn->bm", A, v)

    def mtv(y):
        return jnp.einsum("bmn,bm->bn", A, y)

    def gram(w):
        return (A * w[:, None, :]) @ At

    def normal(d):
        # Symmetric square-root form G G' with G = A diag(d)^-1/2 —
        # bit-identical to the pre-refactor dense path.
        G = A * jax.lax.rsqrt(d)[:, None, :]
        return G @ jnp.swapaxes(G, 1, 2)

    def take(idx):
        return dense_linops(A[idx])

    return LinOps(mv, mtv, gram, normal, take)


def solve_box_lp_batched(c, A, b, l, u,
                         cfg: IPMConfig = IPMConfig(),
                         x_init=None) -> LPBatchSolution:
    """Solve a batch of LPs: min c'x s.t. Ax=b, l<=x<=u.

    Shapes: c,l,u [B,n]; A [B,m,n]; b [B,m]. Public dense entry —
    delegates to :func:`solve_box_lp_ops` over the materialized tensor.
    """
    return solve_box_lp_ops(c, b, l, u,
                            dense_linops(A.astype(jnp.dtype(cfg.dtype))),
                            cfg, x_init=x_init)


def solve_box_lp_ops(c, b, l, u, ops: LinOps,
                     cfg: IPMConfig = IPMConfig(),
                     x_init=None) -> LPBatchSolution:
    """Batched IPM core over an abstract constraint operator.

    ``x_init``: optional warm-start iterate (must lie strictly inside
    the box); used by the compacted-restart recursion below. ``None``
    starts from the box midpoint.
    """
    dtype = jnp.dtype(cfg.dtype)
    c, b = c.astype(dtype), b.astype(dtype)
    l, u = l.astype(dtype), u.astype(dtype)
    B, n = c.shape
    m = b.shape[1]

    factor, chol_solve = _make_chol_ops(m)
    # Structured block-Schur normal solve (dcopf.make_dc_linops): at
    # case300 scale the Schur reduction replaces the [B, 792, 792]
    # factor with two [B, nb, nb] explicit inverses and batched matmuls.
    use_schur = (ops.schur_factor is not None and m > _BLOCKED_MAX_M
                 and cfg.large_m_schur)

    width = u - l
    margin = 1e-9 * _pos(width)
    delta = np.asarray(cfg.regularization, dtype)
    tau = np.asarray(cfg.tau, dtype)
    eye_m = np.eye(m, dtype=dtype)

    def bdot(p, q):  # [B,n],[B,n] -> [B]
        return jnp.sum(p * q, axis=-1)

    def equilibrated_chol(M):
        diag = jnp.diagonal(M, axis1=1, axis2=2)
        s = jax.lax.rsqrt(jnp.maximum(diag, 1e-30))      # [B,m]
        Ms = M * s[:, :, None] * s[:, None, :] + delta * eye_m
        return factor(Ms), s

    def eq_solve(chol_s, rhs):
        chol, s = chol_s
        return s * chol_solve(chol, s * rhs)

    if use_schur:
        s_factor, s_solve = _schur_solvers(
            ops.mv, ops.mtv, ops.schur_factor, ops.schur_solve, delta)
        nfactor = lambda d: s_factor(1.0 / d)
        nsolve = s_solve
    else:
        nfactor = lambda d: equilibrated_chol(ops.normal(d))
        nsolve = eq_solve

    x0 = 0.5 * (l + u)
    y0 = jnp.zeros_like(b)
    z0 = jnp.ones_like(c)

    def newton_step(d, sl, su, zl, zu, rd, rp, rcl, rcu, chol_s):
        rhat = rd - rcl / sl + rcu / su                   # [B,n]
        rhs = rp + ops.mv(rhat / d)                       # [B,m]
        dy = nsolve(chol_s, rhs)
        dx = (ops.mtv(dy) - rhat) / d
        dzl = (rcl - zl * dx) / sl
        dzu = (rcu + zu * dx) / su
        return dx, dy, dzl, dzu

    def max_step(sl, su, zl, zu, dx, dzl, dzu):
        big = np.asarray(1e30, dtype)
        ap = jnp.minimum(
            jnp.min(jnp.where(dx < 0, -sl / jnp.minimum(dx, -1e-30), big),
                    axis=-1),
            jnp.min(jnp.where(dx > 0, su / jnp.maximum(dx, 1e-30), big),
                    axis=-1))
        ad = jnp.minimum(
            jnp.min(jnp.where(dzl < 0, -zl / jnp.minimum(dzl, -1e-30), big),
                    axis=-1),
            jnp.min(jnp.where(dzu < 0, -zu / jnp.minimum(dzu, -1e-30), big),
                    axis=-1))
        return (jnp.minimum(tau * ap, 1.0)[:, None],
                jnp.minimum(tau * ad, 1.0)[:, None])

    def body(_, state):
        x, y, zl, zu, done, best_score, best_x = state
        sl = _pos(x - l)
        su = _pos(u - x)
        rp = b - ops.mv(x)
        rd = c - ops.mtv(y) - zl + zu
        mu = (bdot(sl, zl) + bdot(su, zu)) / (2 * n)      # [B]

        score = mu + jnp.max(jnp.abs(rp), axis=-1)
        better = score < best_score
        best_score = jnp.where(better, score, best_score)
        best_x = jnp.where(better[:, None], x, best_x)

        done = done | (mu < cfg.mu_tol)

        d = jnp.clip(zl / sl + zu / su, 1e-6, 1e10)
        chol_s = nfactor(d)

        centering = (mu < cfg.center_tol)[:, None]

        dxa, dya, dzla, dzua = newton_step(
            d, sl, su, zl, zu, rd, rp, -sl * zl, -su * zu, chol_s)
        apa, ada = max_step(sl, su, zl, zu, dxa, dzla, dzua)
        mu_aff = (bdot(sl + apa * dxa, zl + ada * dzla)
                  + bdot(su - apa * dxa, zu + ada * dzua)) / (2 * n)
        sigma = jnp.where(
            centering[:, 0], 0.5,
            jnp.clip((mu_aff / _pos(mu)) ** 3, 0.0, 1.0))[:, None]
        gate = jnp.where(centering, 0.0, 1.0)

        rcl = sigma * mu[:, None] - sl * zl - gate * dxa * dzla
        rcu = sigma * mu[:, None] - su * zu + gate * dxa * dzua
        dx, dy, dzl, dzu = newton_step(
            d, sl, su, zl, zu, rd, rp, rcl, rcu, chol_s)
        ap, ad = max_step(sl, su, zl, zu, dx, dzl, dzu)
        damp = jnp.where(centering, 0.9, 1.0)
        ap = damp * ap
        ad = damp * ad

        xn = jnp.clip(x + ap * dx, l + margin, u - margin)
        yn = y + ad * dy
        zln = _pos(zl + ad * dzl)
        zun = _pos(zu + ad * dzu)

        finite = (jnp.all(jnp.isfinite(xn), axis=-1)
                  & jnp.all(jnp.isfinite(yn), axis=-1)
                  & jnp.all(jnp.isfinite(zln), axis=-1)
                  & jnp.all(jnp.isfinite(zun), axis=-1))
        keep = (done | ~finite)[:, None]
        done = done | ~finite
        x = jnp.where(keep, x, xn)
        y = jnp.where(keep, y, yn)
        zl = jnp.where(keep, zl, zln)
        zu = jnp.where(keep, zu, zun)
        return (x, y, zl, zu, done, best_score, best_x)

    def one_pass(x_init, iters: int | None = None) -> LPBatchSolution:
        state = (x_init, y0, z0, z0, jnp.zeros_like(b[:, 0], dtype=bool),
                 jnp.full_like(b[:, 0], jnp.inf), x_init)
        x, y, zl, zu, _, best_score, best_x = jax.lax.fori_loop(
            0, iters or cfg.iterations, body, state)
        return polish_box_lp(
            (x, y, zl, zu, best_score, best_x), c, b, l, u, cfg,
            mv_fn=ops.mv, mtv_fn=ops.mtv, gram_fn=ops.gram,
            schur=((ops.schur_factor, ops.schur_solve) if use_schur
                   else None))

    sol = one_pass(x_init if x_init is not None else x0)
    # Large-m stall rescue: lanes can converge to near-complementary but
    # SUBOPTIMAL points when f32 Newton directions degrade (gap ~ 2n*mu
    # => tens of MW of hidden objective error at m ~ 792). A second pass
    # warm-started from the POLISHED (projected + crossover-snapped)
    # solution — pushed strictly inside the box, fresh duals — resets the
    # barrier weights and escapes the stall (measured: 7.7 -> 0.7 MW max
    # DNS error vs HiGHS f64 on the case300s deep-contingency suite).
    # Per-lane merge keeps whichever pass is better (feasibility first,
    # then objective), so well-converged lanes cannot regress.
    n_restarts = (cfg.restarts if cfg.restarts is not None
                  else (1 if m > _BLOCKED_MAX_M else 0))
    # Clamped to the buffer: a buffer no larger than restart_compact
    # (the 4-lane stress suites, tiny probe runs) takes the whole-buffer
    # "compacted" restart — which is exactly a full restart pass, but
    # through the DENSE rescue sub-solve (essential under the Schur
    # bulk pass: the rescue must not share the bulk pass's failure
    # mode on hard lanes).
    k = min(cfg.restart_compact, B)
    if n_restarts > 0 and m > _BLOCKED_MAX_M and 0 < k:
        # Compacted restart (round 3): at m = 792 an unconditional
        # full-buffer restart doubles the whole case300 step — yet in
        # production only a handful of lanes per buffer are past the
        # point a restart can
        # improve (real-miss pass-1 quality quantiles in
        # results/case300_lpq.json). Compact the worst-k lanes by the
        # same quality score the evaluator trusts (rp + 2n*mu, a duality
        # -gap bound at feasibility) and give THEM the full restart +
        # escalation pipeline via recursion, warm-started from their
        # polished pass-1 iterate. Lanes left behind are the buffer's
        # best-scored: their gap bound keeps them within the evaluator's
        # noise floor, and the cond-gated full-batch escalation below
        # still fires if anything past restart_compact lanes stays bad
        # (adversarial all-hard batches, e.g. the deep-contingency
        # stress suite). Per-lane merge keeps whichever solution wins.
        score = sol.primal_residual + 2 * n * sol.duality_gap
        # The rescue sub-solve runs the DENSE factorization: the worst-k
        # lanes are exactly the ones whose barrier weights have drifted
        # into the regimes where the block-Schur solve's f32 error grows
        # (pinned-flow cancellation), and at k ~ 32 lanes the dense
        # [k, m, m] factor is cheap. Fast Schur for the bulk pass,
        # dense Cholesky for the hard-lane ladder. restarts=0 and
        # escalate_passes=0: the explicit cold -> warm -> restore chain
        # below replaces both (each stage gated, merges monotone).
        sub_cfg = dataclasses.replace(
            cfg, restart_compact=0, large_m_schur=False, restarts=0,
            escalate_passes=0,
            iterations=(cfg.rescue_iterations
                        if cfg.rescue_iterations is not None
                        else cfg.iterations))

        def run_rescue(sol_in):
            # Rescue stage ladder (round 4). The m=792 f32 pass-1 has
            # two failure modes that need OPPOSITE treatments, and the
            # jammed mode needs a NON-monotone trajectory, so the
            # ladder separates the trajectory (what each stage starts
            # from) from the output (a monotone per-lane merge):
            #   warm 2%:    step-length-jammed lanes (gap tiny, rp
            #               stuck ~1e-2 at a degenerate vertex; a cold
            #               re-solve deterministically re-jams;
            #               the 2% inset escapes the jam into the true
            #               objective basin).
            #   cold:       garbage-basin lanes (huge duality gap; a
            #               warm start traps the sub-solve at the same
            #               suboptimal point — 154 MW observed). Side
            #               branch: feeds the merge, not the
            #               trajectory.
            #   warm 1e-3 x2: feasibility restoration — the 2% inset
            #               on the +-6 rad theta box is a 0.24 rad
            #               balance perturbation, so the warm stage
            #               leaves rp ~ 6e-3; interiority-only insets
            #               from the TRAJECTORY point converge rp while
            #               holding the basin. The intermediate iterate
            #               can score WORSE than the best-so-far
            #               (measured on stress lane 82: 6.3e-3 ->
            #               1.3e-2 -> 3.0e-3, final DNS err 0.33 MW;
            #               lane 106: 6.6e-2 -> 1.0e-2 -> 2.4e-3, err
            #               0.19 MW) — hence trajectory, not best,
            #               feeds the next start.
            # Every stage is cond-gated on the BEST-so-far worst score,
            # so a batch whose bad lanes clean up early skips the rest:
            # the common-case rescue stays ~one dense pass.
            _, idx = jax.lax.top_k(score, k)
            li, ui = l[idx], u[idx]
            wid = ui - li
            sub_ops = ops.take(idx)
            cs, bs_ = c[idx], b[idx]
            best = LPBatchSolution(
                x=sol_in.x[idx], objective=sol_in.objective[idx],
                primal_residual=sol_in.primal_residual[idx],
                duality_gap=sol_in.duality_gap[idx])

            def stage(inset):
                def f(state):
                    best_in, probe_x = state
                    if inset is None:           # cold side branch
                        x0 = 0.5 * (li + ui)
                    else:
                        x0 = jnp.clip(probe_x, li + inset * wid,
                                      ui - inset * wid)
                    s = solve_box_lp_ops(cs, bs_, li, ui, sub_ops,
                                         sub_cfg, x_init=x0)
                    new_probe = probe_x if inset is None else s.x
                    return (_merge_lanes(s, best_in), new_probe)
                return f

            state = (best, best.x)
            for inset in cfg.rescue_stages:
                sc = (state[0].primal_residual
                      + 2 * n * state[0].duality_gap)
                state = jax.lax.cond(
                    jnp.any(sc > cfg.escalate_tol),
                    stage(inset), lambda s: s, state)
            best = state[0]

            cand = LPBatchSolution(
                x=sol_in.x.at[idx].set(best.x),
                objective=sol_in.objective.at[idx].set(best.objective),
                primal_residual=sol_in.primal_residual.at[idx].set(
                    best.primal_residual),
                duality_gap=sol_in.duality_gap.at[idx].set(
                    best.duality_gap))
            return tuple(_merge_lanes(cand, sol_in))

        # Cond-gated: a buffer whose every lane already meets the
        # evaluator's 5e-3 trust tolerance has nothing to rescue — the
        # left-behind bound that justified compaction in round 3 then
        # covers the WHOLE buffer, and the clean-batch fast path skips
        # the dense pass entirely (the common case once certificates +
        # shed hint route only benign lanes here).
        sol = LPBatchSolution(*jax.lax.cond(
            jnp.any(score > cfg.escalate_tol), run_rescue,
            lambda sol_in: tuple(sol_in), sol))
        n_restarts = 0   # the sub-solve ran them (plus its escalation)
    for _ in range(n_restarts):
        prev = sol
        # Full-length restart pass: a half-length (8-iter) pass matched
        # 16 on CPU but lost deep lanes on an accelerator whose f32
        # accumulation order differs (a 57.6 MW shed degraded to its
        # zero copper bound) — stalled lanes need the full budget. Keep
        # iterations symmetric.
        sol = one_pass(jnp.clip(sol.x, l + 0.02 * width, u - 0.02 * width))
        sol = _merge_lanes(sol, prev)

    # Per-lane escalation: the unconditional restart still leaves ~1
    # lane per few hundred at m ~ 792 stalled past the evaluator's
    # 5e-3 trust guard (results/case300_parity.json round 2:
    # quality_max 8.4e-3, a 1.13 MW hidden error degraded to its copper
    # bound). Those lanes are rare by construction, so the extra passes
    # run under lax.cond gated on the batch's worst quality score —
    # a clean batch pays one scalar reduction, nothing else. Each pass
    # warm-starts deeper inside the box than the last (0.02 -> 0.05 ->
    # 0.1 of width) so a lane stuck in the same near-complementary
    # basin gets a genuinely different barrier trajectory.
    for i in range(cfg.escalate_passes if m > _BLOCKED_MAX_M else 0):
        prev = sol
        trip = jnp.any(prev.primal_residual + 2 * n * prev.duality_gap
                       > cfg.escalate_tol)
        inset = (0.05, 0.1)[min(i, 1)]
        sol = jax.lax.cond(
            trip,
            lambda xv: tuple(one_pass(
                jnp.clip(xv, l + inset * width, u - inset * width))),
            lambda xv: tuple(prev),
            prev.x)
        sol = _merge_lanes(LPBatchSolution(*sol), prev)
    return sol
