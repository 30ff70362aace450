"""Batched DC-OPF minimum-load-shedding evaluator (HL2 state evaluation).

Replaces the reference's per-state ``runopf`` calls (MATPOWER MIPS DC-OPF
with dispatchable-load "virtual generators": ``mc_simulation.m:32-99``,
``seq_mcsimulation.m:432-507``, load transform ``dispaload.m:30-87``) with a
two-tier batched evaluator:

**Tier 1 — exact certificate (vectorized, no LP).** For a state with no
branch outage, DNS is lower-bounded by the copper-sheet deficit
``max(0, load - available capacity)``; if a concrete dispatch/shed pattern
achieving that bound passes the intact-network PTDF flow check, the bound
is *provably optimal*. The zero-deficit version of this certificate
resolves the large majority of sampled states with a couple of matmuls.

**Tier 2 — interior-point LP in B-theta form** for everything else
(branch outages, islands, congestion):

    variables  x = [Pg (ng), shed (nd), f (nl), theta (nb)]
    minimize   sum(shed)
    s.t.       Cg Pg + Cd shed - Minc' f = bus_load          (nb rows)
               (1/b_l) f_l - status_l (theta_i - theta_j) = 0 (nl rows)
               0 <= Pg <= Pmax,  0 <= shed <= load,
               |f| <= rate,  |theta| <= theta_max
    (out-of-service units are zeroed COLUMNS of the balance block — the
    LP bounds are state-independent.)

Why B-theta instead of a PTDF LP: branch outages and island formation
change the PTDF but only *mask rows* here — every outage pattern (including
network splits, which single-line outages can cause on RTS-24: line 7-8
islands bus 7) compiles to the same static-shape LP, and per-island power
balance emerges from the node equations themselves. The angle translation
null-space of islands is absorbed by the solver's diagonal regularization
and the symmetric theta box.

DNS equals the LP objective (in MW: objective * base_mva), matching the
reference identity DNS = Result.f + total_load (mc_simulation.m:54).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from powersystemsreliabilityassessment.core.system import System
from powersystemsreliabilityassessment.engines import lp_ipm
from powersystemsreliabilityassessment.utils.config import CompatFlags, IPMConfig


class EvalResult(NamedTuple):
    dns_mw: jax.Array        # [B] total demand not supplied, MW
    nodal_mw: jax.Array      # [B, nb] per-bus shed, MW
    failure: jax.Array       # [B] bool: dns above the failure-flag threshold
    primal_residual: jax.Array  # [B] LP feasibility diagnostics
    gen_dispatch: jax.Array  # [B, ng] p.u. (diagnostics / tests)
    infeasible: jax.Array    # [B] bool: state has NO feasible dispatch
    #   (committed Pmin > demand under enforce_pmin). The reference's
    #   try/catch silently records zero on such MATPOWER failures
    #   (seqMain.m:117-126); here the lane is flagged and counted so
    #   studies can report it explicitly.


class Certificate(NamedTuple):
    certified: jax.Array   # [B] bool: deficit proven optimal
    deficit: jax.Array     # [B] p.u. copper-sheet DNS lower bound
    shed: jax.Array        # [B, nd] p.u. certificate shed pattern
    dispatch: jax.Array    # [B, ng] p.u. certificate dispatch


def build_state_lp(sys: System, gen_up: jax.Array, br_up: jax.Array,
                   load_pu: jax.Array, compat: CompatFlags,
                   theta_max: float):
    """Assemble (c, A, b, l, u) for one system state.

    ``gen_up`` [ng], ``br_up`` [nl] are 1.0 when the component is in
    service; ``load_pu`` [nd] is the per-load-bus demand for this state's
    hour (peak * hourly factor).
    """
    ng, nd, nl, nb = sys.n_gen, sys.n_load, sys.n_branch, sys.n_bus
    dt = sys.bus_pd.dtype

    # Static constants are built with NUMPY throughout this module: a jnp
    # creation with no tracer input executes EAGERLY at trace time — one
    # device dispatch each, and a blocking device-to-host fetch at MLIR
    # lowering. Host numpy constants embed for free.
    c = np.concatenate([
        np.zeros((ng,), dt), np.ones((nd,), dt),
        np.zeros((nl + nb,), dt),
    ])

    # Out-of-service (and zero-capacity, e.g. synchronous-condenser) units
    # are handled by ZEROING their balance-equation column rather than
    # shrinking their box to width ~0: degenerate boxes wreck the interior
    # point's complementarity scaling in float32, while a zero column simply
    # disconnects the variable (exactly MATPOWER's removed-unit semantics,
    # and it keeps the LP bounds constant across scenarios).
    has_cap = (sys.gen_pmax > 0).astype(dt)
    gen_col = gen_up * has_cap

    # Balance block [nb, n]: Cg Pg + Cd s - Minc' f = bus_load
    bal = jnp.concatenate([
        sys.gen_bus_onehot * gen_col[None, :], sys.load_onehot,
        -sys.incidence.T, np.zeros((nb, nb), dt),
    ], axis=1)
    # Flow block [nl, n]: (1/b) f - status * Minc theta = 0. The reference
    # bus's theta column is ZEROED (same column-disconnection trick as the
    # out-of-service gens): that gauge-fixes theta_0 = 0 exactly — the
    # standard DC power-flow reference elimination — removing the uniform
    # angle-shift null mode from A instead of leaving the interior point
    # to float it across the box.
    ref_mask = (np.arange(nb) != 0).astype(dt)
    flow = jnp.concatenate([
        np.zeros((nl, ng + nd), dt),
        jnp.diag(1.0 / sys.b_susceptance),
        -br_up[:, None] * sys.incidence * ref_mask[None, :],
    ], axis=1)
    A = jnp.concatenate([bal, flow], axis=0)

    b = jnp.concatenate([sys.load_onehot @ load_pu, np.zeros((nl,), dt)])

    eps = np.asarray(1e-6, dt)
    pmin = sys.gen_pmin if compat.enforce_pmin else np.zeros((ng,), dt)
    pmax = jnp.maximum(sys.gen_pmax, pmin + eps)
    pmax = jnp.where(sys.gen_pmax > 0, pmax, 1.0)  # zero-cap: dummy box
    # Per-bus angle boxes (System.theta_bound, a provable min-path bound
    # vs the gauge-fixed reference) capped by the configured theta_max:
    # tight boxes keep the float32 normal matrices well-conditioned on
    # large tiled systems (the flat +-6 rad box left near-null inter-area
    # modes that stalled the IPM at m >~ 190).
    tb = jnp.minimum(sys.theta_bound, theta_max)
    l = jnp.concatenate([
        pmin, np.zeros((nd,), dt), -sys.br_rate, -tb,
    ])
    u = jnp.concatenate([
        pmax, jnp.maximum(load_pu, eps), sys.br_rate, tb,
    ])
    return c, A, b, l, u


def build_state_lp_vectors(sys: System, gen_up: jax.Array,
                           br_up: jax.Array, load_pu: jax.Array,
                           compat: CompatFlags, theta_max: float):
    """Batched (c, b, l, u, colscale) WITHOUT materializing A.

    The constraint matrix itself is represented structurally (see
    :func:`make_dc_linops`): across lanes it differs from the
    shared blocks only by ``colscale`` (generator availability on the
    balance columns) and ``br_up`` (branch status on the flow rows).
    Bound/cost semantics identical to :func:`build_state_lp`.
    """
    ng, nd, nl, nb = sys.n_gen, sys.n_load, sys.n_branch, sys.n_bus
    dt = sys.bus_pd.dtype
    B = gen_up.shape[0]

    # [B, 1] zero tied to the batch tracer: `zeroB + v[None, :]` broadcasts
    # a shared vector to [B, n] INSIDE the trace (XLA fuses the add away)
    # — a plain jnp.ones/broadcast_to of a constant would instead
    # materialize eagerly at trace time (see build_state_lp note).
    zeroB = jnp.zeros_like(gen_up[:, :1])
    bcast = lambda v: zeroB + v[None, :]

    has_cap = (sys.gen_pmax > 0).astype(dt)
    colscale = jnp.concatenate([
        gen_up * has_cap[None, :],
        bcast(np.ones((nd + nl + nb,), dt))], axis=1)

    c = bcast(np.concatenate([
        np.zeros((ng,), dt), np.ones((nd,), dt),
        np.zeros((nl + nb,), dt)]))

    b = jnp.concatenate([load_pu @ sys.load_onehot.T,
                         jnp.zeros_like(gen_up[:, :1]) +
                         np.zeros((1, nl), dt)], axis=1)

    eps = np.asarray(1e-6, dt)
    pmin = sys.gen_pmin if compat.enforce_pmin else np.zeros((ng,), dt)
    pmax = jnp.maximum(sys.gen_pmax, pmin + eps)
    pmax = jnp.where(sys.gen_pmax > 0, pmax, 1.0)
    tb = jnp.minimum(sys.theta_bound, theta_max)
    l = bcast(jnp.concatenate([
        pmin, np.zeros((nd,), dt), -sys.br_rate, -tb]))
    u = jnp.concatenate([
        bcast(pmax),
        jnp.maximum(load_pu, eps),
        bcast(sys.br_rate),
        bcast(tb)], axis=1)
    return c, b, l, u, colscale


# Relative flow-block diagonal lift for the block-Schur normal solve
# (make_dc_linops.schur_factor): bounds the 1/dphi cancellation
# amplification on pinned-flow lanes; compensated exactly in the Schur
# complement's gamma term and removed by the IPM's refinement against
# the true operator.
_SCHUR_LIFT = 1e-5


def make_dc_linops(sys: System, gen_col: jax.Array, br_up: jax.Array):
    """Structured :class:`lp_ipm_batched.LinOps` for the DC-OPF LP.

    Exploits :func:`build_state_lp`'s block layout (variables
    [pg | shed | f | theta], rows [balance | flow]) so the IPM core
    never materializes the [B, m, n] constraint tensor:

      A v / A' y       one-hot scatter + incidence matmuls, O(B*n*nb)
      A diag(w) A'     block assembly — the balance-balance block is a
                       wf-weighted graph Laplacian plus a diagonal of
                       scattered gen/shed weights, balance-flow is a
                       scaled incidence (elementwise), flow-flow is a
                       diagonal plus the br_up-masked theta Laplacian
                       congruence.

    At case300s (nb=300, nl=492, n=1392) the gram assembly costs
    ~30 GFLOP per 128-lane iteration vs ~224 GFLOP for the dense
    (A*w)@A' product — and removes the 570 MB [B, m, n] residency.
    Lane variation enters only through ``gen_col`` ([B, ng], the
    balance-column scaling = gen_up * (pmax > 0)) and ``br_up``
    ([B, nl], the flow-row theta scaling), exactly the two scalings
    ``build_state_lp`` applies to the shared blocks.
    """
    from powersystemsreliabilityassessment.engines.lp_ipm_batched import (
        LinOps)
    ng, nd, nl, nb = sys.n_gen, sys.n_load, sys.n_branch, sys.n_bus
    dt = sys.bus_pd.dtype
    cg = sys.gen_bus_onehot          # [nb, ng]
    cd = sys.load_onehot             # [nb, nd]
    minc = sys.incidence             # [nl, nb]
    ref_mask = (np.arange(nb) != 0).astype(np.float32)
    mref = minc * ref_mask[None, :]  # gauge-fixed theta columns
    inv_b = 1.0 / sys.b_susceptance  # [nl]
    inv_b2 = inv_b * inv_b
    eye_nb = np.eye(nb, dtype=dt)
    eye_nl = np.eye(nl, dtype=dt)
    f_lo, f_hi = ng + nd, ng + nd + nl

    def split(v):
        return v[:, :ng], v[:, ng:f_lo], v[:, f_lo:f_hi], v[:, f_hi:]

    def mv(v):
        vg, vs, vf, vt = split(v)
        bal = (gen_col * vg) @ cg.T + vs @ cd.T - vf @ minc
        flow = vf * inv_b[None, :] - br_up * (vt @ mref.T)
        return jnp.concatenate([bal, flow], axis=1)

    def mtv(y):
        yb, yf = y[:, :nb], y[:, nb:]
        return jnp.concatenate([
            gen_col * (yb @ cg),
            yb @ cd,
            inv_b[None, :] * yf - yb @ minc.T,
            -(br_up * yf) @ mref], axis=1)

    def gram(w):
        wg, ws, wf, wt = split(w)
        dbal = (wg * gen_col * gen_col) @ cg.T + ws @ cd.T   # [B, nb]
        lap = jnp.einsum("lb,Blc->Bbc", minc, wf[:, :, None] * minc)
        mbb = lap + dbal[:, :, None] * eye_nb
        mbf = -minc.T[None] * (wf * inv_b[None, :])[:, None, :]
        k = jnp.einsum("Blb,kb->Blk", mref[None] * wt[:, None, :], mref)
        mff = (br_up[:, :, None] * k * br_up[:, None, :]
               + (wf * inv_b2[None, :])[:, :, None] * eye_nl)
        return jnp.concatenate([
            jnp.concatenate([mbb, mbf], axis=2),
            jnp.concatenate([jnp.swapaxes(mbf, 1, 2), mff], axis=2)],
            axis=1)

    def normal(d):
        return gram(1.0 / d)

    def schur_factor(w, ridge: float = 0.0, delta: float = 1e-6):
        """Block-Schur factorization of ``A diag(w) A' + ridge*I``.

        The m = nb + nl normal matrix of this LP has the 2x2 block form
        [[lap(wf) + diag(dbal), -minc' diag(wf/b)], [., diag(wf/b^2) +
        (br_up mref)' diag(wt) (br_up mref)]]. Two exact reductions
        collapse its solve to TWO [nb, nb] SPD systems:

        1. Woodbury through the flow block:  N_ff^-1 = Dphi^-1 -
           Dphi^-1 U K^-1 U' Dphi^-1 with U = br_up*mref and
           K = diag(1/wt) + mref' diag(br_up^2 / Dphi) mref.
        2. Schur onto the balance block, where the Laplacian term
           cancels ANALYTICALLY against the flow sandwich when
           ridge = 0 (diag(wf/b) Dphi^-1 diag(wf/b) = diag(wf)):
           S = diag(dbal) + G K^-1 G' [+ lap(wf*ridge/Dphi)] with
           G = minc' diag(wf/b * br_up / Dphi) mref (= minc'
           diag(b*br_up) mref at ridge 0 — independent of w).

        At case300s this replaces the latency-bound [B, 792, 792]
        factorization with two [B, 300, 300] explicit inverses built
        from batched matmuls (ops/xla_chol.py). f32 error from the
        explicit inverses/ridge is removed by the caller's refinement
        against the matrix-free operator plus the IPM's quality-guard/
        escalation ladder (same contract as the dense f32 path).
        Replaces MATPOWER MIPS's per-state sparse factorization
        (mc_simulation.m:41) at the scale where MATLAB's serial loop
        is the reference's bottleneck (README.md:47-49).
        """
        from powersystemsreliabilityassessment.ops import xla_chol
        wg, ws, wf, wt = split(w)
        dbal = (wg * gen_col * gen_col) @ cg.T + ws @ cd.T + ridge
        alpha = wf * inv_b[None, :]                      # [B, nl]
        # Relative diagonal lift on the flow block: the Woodbury
        # application divides by dphi, and lanes with wf -> 0 (flow
        # variable pinned at a bound, d_f huge) make that division a
        # catastrophic f32 cancellation amplifier. Lifting dphi by a
        # small fraction of the theta-congruence row scale q bounds the
        # amplification; the lift is compensated EXACTLY in S via the
        # gamma term below, so the factorization represents the lifted
        # matrix consistently and the caller's refinement vs the true
        # operator removes it (contraction ~ _SCHUR_LIFT relative).
        q = br_up * br_up * (wt @ (mref * mref).T)       # [B, nl]
        dphi = wf * inv_b2 + ridge + _SCHUR_LIFT * q
        kw = br_up * br_up / dphi
        K = (jnp.einsum("lb,Bl,lc->Bbc", mref, kw, mref)
             + (1.0 / wt)[:, :, None] * eye_nb)
        Kinv = xla_chol.inv_spd_equilibrated(K, delta)

        def ksolve_mat(V):                               # K^-1 V, refined
            Z = jnp.einsum("bij,bjk->bik", Kinv, V)
            return Z + jnp.einsum(
                "bij,bjk->bik", Kinv,
                V - jnp.einsum("bij,bjk->bik", K, Z))

        gw = alpha * br_up / dphi
        G = jnp.einsum("lb,Bl,lc->Bbc", minc, gw, mref)
        S = jnp.einsum("bij,bjk->bik", G, ksolve_mat(jnp.swapaxes(G, 1, 2)))
        S = 0.5 * (S + jnp.swapaxes(S, 1, 2))
        # Exact residue of the balance-block sandwich: lap(wf) -
        # minc' diag(alpha^2/dphi) minc = lap(gamma) with gamma =
        # wf * (dphi - wf*inv_b^2)/dphi — zero only at ridge = lift = 0;
        # this form has no cancellation.
        gam = wf * (ridge + _SCHUR_LIFT * q) / dphi
        S = S + jnp.einsum("lb,Bl,lc->Bbc", minc, gam, minc)
        S = S + dbal[:, :, None] * eye_nb
        Sinv = xla_chol.inv_spd_equilibrated(S, delta)
        return (alpha, dphi, K, Kinv, S, Sinv)

    def schur_solve(F, r):
        """One block-elimination pass y ~ N^-1 r (caller refines)."""
        alpha, dphi, K, Kinv, S, Sinv = F
        rb, rf = r[:, :nb], r[:, nb:]

        def kvec(v):                                     # K^-1 v, refined
            z = jnp.einsum("bi,bij->bj", v, Kinv)
            return z + jnp.einsum(
                "bi,bij->bj",
                v - jnp.einsum("bij,bj->bi", K, z), Kinv)

        def ff_inv(v):                                   # N_ff^-1 v
            # Solve form: subtract in v's scale BEFORE the 1/dphi
            # division (the difference-of-inverses form amplifies f32
            # error by 1/dphi twice).
            h = kvec((br_up * (v / dphi)) @ mref)
            return (v - br_up * (h @ mref.T)) / dphi

        u = ff_inv(rf)
        rhs_b = rb + (alpha * u) @ minc                  # rb - N_bf u
        yb = jnp.einsum("bi,bij->bj", rhs_b, Sinv)
        yb = yb + jnp.einsum(
            "bi,bij->bj",
            rhs_b - jnp.einsum("bij,bj->bi", S, yb), Sinv)
        yf = ff_inv(rf + alpha * (yb @ minc.T))          # rf - N_fb yb
        return jnp.concatenate([yb, yf], axis=1)

    def take(idx):
        return make_dc_linops(sys, gen_col[idx], br_up[idx])

    return LinOps(mv, mtv, gram, normal, take,
                  schur_factor=schur_factor, schur_solve=schur_solve)


def connected_to_ref(sys: System, br_up: jax.Array) -> jax.Array:
    """[B, nb] bool: bus is in the reference bus (bus 0) island.

    Boolean reachability by repeated squaring of the in-service adjacency
    matrix (5 squarings cover path length 32 > any bus count here) — all
    batched matmuls, no data-dependent control flow.
    """
    nb, nl = sys.n_bus, sys.n_branch
    dt = sys.bus_pd.dtype
    e_from = sys.incidence > 0       # [nl, nb] one-hot from-bus
    e_to = sys.incidence < 0
    pair = (e_from.astype(dt)[:, :, None] * e_to.astype(dt)[:, None, :])
    pair = pair + jnp.swapaxes(pair, 1, 2)       # [nl, nb, nb] symmetric
    adj = np.eye(nb, dtype=dt) + jnp.einsum("bl,lij->bij", br_up, pair)
    reach = jnp.minimum(adj, 1.0)
    for _ in range(5):
        reach = jnp.minimum(reach @ reach, 1.0)
    return reach[:, 0, :] > 0.5


def apply_island_blackout(sys: System, comp_down: jax.Array,
                          load_pu: jax.Array):
    """Compat transform: disconnected loads are shed outright, disconnected
    generators become unavailable. Returns (comp_down', load_pu',
    islanded_nodal_mw [B, nb])."""
    ng = sys.n_gen
    br_up = 1.0 - comp_down[:, ng:].astype(sys.bus_pd.dtype)
    reach = connected_to_ref(sys, br_up)                   # [B, nb]
    load_reach = jnp.take_along_axis(
        reach, jnp.broadcast_to(sys.load_bus_index[None, :],
                                (reach.shape[0], sys.n_load)), axis=1)
    gen_reach = jnp.take_along_axis(
        reach, jnp.broadcast_to(
            jnp.argmax(sys.gen_bus_onehot, axis=0)[None, :],
            (reach.shape[0], ng)), axis=1)
    comp_down = comp_down.at[:, :ng].set(comp_down[:, :ng] | ~gen_reach)
    shed_pu = jnp.where(load_reach, 0.0, load_pu)
    nodal = (shed_pu * sys.base_mva) @ sys.load_onehot.T
    return comp_down, jnp.where(load_reach, load_pu, 0.0), nodal


def _rebalance_shed(cand: jax.Array, caps: jax.Array,
                    target: jax.Array) -> jax.Array:
    """Exactly rebalance a nonnegative pattern to sum ``target`` within
    per-element ``caps``: scale down multiplicatively (stays in bounds),
    scale up proportional to remaining headroom (cannot strand residual as
    long as target <= sum(caps))."""
    total = jnp.sum(cand, axis=1)
    resid = total - target                                 # [B]
    down_scale = jnp.where(
        total > 1e-9, jnp.maximum(target, 0.0) / jnp.maximum(total, 1e-9),
        0.0)
    headroom = jnp.maximum(caps - cand, 0.0)
    head_tot = jnp.maximum(jnp.sum(headroom, axis=1), 1e-9)
    up = cand + headroom * ((-resid) / head_tot)[:, None]
    return jnp.where((resid >= 0)[:, None], cand * down_scale[:, None],
                     jnp.minimum(up, caps))


def _unrolled_det(E: list[list]) -> jax.Array:
    """Determinant of a k x k matrix given as lists of [B] arrays —
    compile-time Laplace expansion (k <= 4: at most 24 products), all
    elementwise VPU code. No batched LU, no per-lane pivoting/gathers."""
    k = len(E)
    if k == 1:
        return E[0][0]
    det = None
    for j in range(k):
        minor = [[E[r][c] for c in range(k) if c != j]
                 for r in range(1, k)]
        term = E[0][j] * _unrolled_det(minor)
        term = term if j % 2 == 0 else -term
        det = term if det is None else det + term
    return det


def _cramer_solve(E: list[list], f: list, safe_det: jax.Array) -> list:
    """Solve E c = f by Cramer's rule (unrolled; k <= 4)."""
    k = len(E)
    return [_unrolled_det([[f[r] if c == i else E[r][c]
                            for c in range(k)] for r in range(k)])
            / safe_det for i in range(k)]


def _shed_candidate(sys: System, load_pu: jax.Array, deficit: jax.Array,
                    load_tot: jax.Array,
                    shed_hint: jax.Array | None) -> jax.Array:
    """Load-proportional (or hint-scaled) shed pattern at exactly the
    copper bound, rebalanced within per-load caps."""
    prop = load_pu * (deficit / jnp.maximum(load_tot, 1e-9))[:, None]
    if shed_hint is None:
        cand = prop
    else:
        hint_sum = jnp.sum(shed_hint, axis=1)
        scaled = shed_hint * (deficit / jnp.maximum(hint_sum, 1e-9))[:, None]
        cand = jnp.where((hint_sum > 1e-6)[:, None], scaled, prop)
    cand = jnp.minimum(cand, load_pu)
    return _rebalance_shed(cand, load_pu, deficit)


def _dispatch_candidate(sys: System, gen_cap: jax.Array, load_pu: jax.Array,
                        cand: jax.Array, served: jax.Array) -> jax.Array:
    """Locally self-balancing dispatch candidate: each bus's generators
    first cover that bus's (post-shed) load, and only the residual is
    pooled across the remaining headroom. This keeps nodal injections —
    and therefore candidate flows — near zero, which is what lets the
    certificate pass on multi-area systems where a uniform-alpha
    dispatch would force large inter-area transfers."""
    served_bus = (load_pu - cand) @ sys.load_onehot.T      # [B, nb]
    cap_bus = gen_cap @ sys.gen_bus_onehot.T               # [B, nb]
    local_frac = jnp.minimum(
        served_bus / jnp.maximum(cap_bus, 1e-9), 1.0)      # [B, nb]
    disp_local = gen_cap * (local_frac @ sys.gen_bus_onehot)
    return _rebalance_shed(disp_local, gen_cap, served)


def _repair_descent(sys: System, repair_iters: int, rate_ok: jax.Array,
                    ptdf_gen: jax.Array, ptdf_load: jax.Array,
                    lp_, cand_, disp_, gcap_, brd_, served_, deficit_,
                    post0_, ok0_):
    """Flow-repair descent on LODF-corrected post-outage flows,
    parameterized over the (possibly compacted) lane set. Moves BOTH
    free quantities along their PTDF sensitivities — the shed pattern
    (d f_l / d shed_i = PTDF[l, load_bus_i]) and the generator dispatch
    (d f_l / d Pg_g = PTDF[l, gen_bus_g]) — re-balances each to its
    exact total, and re-checks. The repaired point is just another
    candidate: if it passes, the copper bound is certified with it;
    otherwise the state falls through to the LP. The gradient carries
    the LODF chain-rule term d post_l / d f = I + e_k lodf[:,k]',
    i.e. w = v + br_down*(v@lodf)."""
    load_bus_ = lp_ @ sys.load_onehot.T

    def flows_full_(disp, shed):
        inj = (disp @ sys.gen_bus_onehot.T + shed @ sys.load_onehot.T
               - load_bus_)
        return inj @ sys.ptdf.T

    def post_flows_(f):
        return (f + (brd_ * f) @ sys.lodf.T) * (1.0 - brd_)

    best_ok_, best_shed_, best_disp_ = ok0_, cand_, disp_
    cur_shed, cur_disp, cur_post = cand_, disp_, post0_
    elig_ = jnp.sum(brd_, axis=1) <= 1
    for _ in range(repair_iters):
        over = jnp.maximum(jnp.abs(cur_post) - sys.br_rate[None, :], 0.0)
        sgn_over = jnp.sign(cur_post) * over
        w = sgn_over + brd_ * (sgn_over @ sys.lodf)   # [*, nl]
        # dispatch adjustment (scaled to the larger of the two totals)
        grad_g = w @ ptdf_gen                         # [*, ng]
        grad_g = grad_g - jnp.mean(grad_g, axis=1, keepdims=True)
        step_g = (jnp.sum(over, axis=1) / jnp.maximum(
            jnp.max(jnp.abs(grad_g), axis=1), 1e-9))[:, None]
        disp_t = jnp.clip(cur_disp - step_g * grad_g, 0.0, gcap_)
        disp_t = _rebalance_shed(disp_t, gcap_, served_)
        # shed adjustment
        grad = w @ ptdf_load                          # [*, nd]
        grad = grad - jnp.mean(grad, axis=1, keepdims=True)
        step_sz = (deficit_ / jnp.maximum(
            jnp.max(jnp.abs(grad), axis=1), 1e-9))[:, None]
        trial = jnp.clip(cur_shed - step_sz * grad, 0.0, lp_)
        trial = _rebalance_shed(trial, lp_, deficit_)
        post_t = post_flows_(flows_full_(disp_t, trial))
        ok_trial = jnp.all(jnp.abs(post_t) <= rate_ok, axis=1)
        # the rank-1-corrected check is exact only for n_out <= 1
        newly = ~best_ok_ & ok_trial & elig_
        best_shed_ = jnp.where(newly[:, None], trial, best_shed_)
        best_disp_ = jnp.where(newly[:, None], disp_t, best_disp_)
        best_ok_ = best_ok_ | ok_trial
        cur_shed, cur_disp, cur_post = trial, disp_t, post_t
    return best_ok_, best_shed_, best_disp_


def _woodbury_multi_ok(sys: System, flows: jax.Array, br_down: jax.Array,
                       n_out: jax.Array, rate_ok: jax.Array,
                       woodbury_k: int) -> jax.Array:
    """MULTI-branch-outage certificate check: exact rank-k Woodbury flow
    update for outage sets of size 2..woodbury_k. With outage set K and
    a = branch-transfer sensitivities, solve (I - a[K, K]) c = f_K, then
    f' = f + a[:, K] c — exact unless removing K islands the network
    (singular E -> falls through to the LP).
    Gather-free: one-hot selectors (an iota compare, elementwise) turn
    every per-lane row/column/element pick of br_transfer into shared
    matmuls and masked reductions — no per-lane gathers — and the
    k x k solve is an unrolled Cramer expansion (elementwise code).
    Unused selector slots (n_out < k) have h_i = 0, which reduces E to
    an identity-padded block and c_i to 0 exactly."""
    dt = flows.dtype
    kk = int(woodbury_k)
    multi = (n_out >= 2) & (n_out <= kk)
    rem = br_down
    hs, fk, rows = [], [], []
    for _ in range(kk):
        ki = jnp.argmax(rem, axis=1)
        vi = jnp.max(rem, axis=1)                    # 1.0 iff a slot used
        hi = jax.nn.one_hot(ki, br_down.shape[1], dtype=dt) * vi[:, None]
        rem = rem * (1.0 - hi)
        hs.append(hi)
        rows.append(hi @ sys.br_transfer)            # br_transfer[k_i, :]
        fk.append(jnp.sum(flows * hi, axis=1))
    E = [[(1.0 if i == j else 0.0) - jnp.sum(rows[i] * hs[j], axis=1)
          for j in range(kk)] for i in range(kk)]
    det = _unrolled_det(E)
    nonsing = jnp.abs(det) > 1e-5
    safe_det = jnp.where(nonsing, det, 1.0)
    cs = _cramer_solve(E, fk, safe_det)
    # sum_i br_transfer[:, k_i] * c_i, as one matmul.
    corr = cs[0][:, None] * hs[0]
    for ci, hi in zip(cs[1:], hs[1:]):
        corr = corr + ci[:, None] * hi
    post_m = (flows + corr @ sys.br_transfer.T) * (1.0 - br_down)
    return (multi & nonsing
            & jnp.all(jnp.abs(post_m) <= rate_ok, axis=1))


def certify_states(sys: System, comp_down: jax.Array, load_pu: jax.Array,
                   shed_hint: jax.Array | None = None,
                   repair_iters: int = 3,
                   repair_buffer: int | None = None,
                   woodbury_k: int = 2) -> Certificate:
    """Tier-1 exact bound certificate (batch).

    For states with no branch outage: DNS >= deficit = max(0, load - cap).
    Build a balanced dispatch/shed candidate at exactly that bound (using
    ``shed_hint``'s pattern when provided, else load-proportional) and
    check the intact-network PTDF flows. If they pass, the bound is the
    exact optimum of the Tier-2 LP.

    For states with ONE outaged branch the same candidate is checked (and
    repaired) against the exact rank-1 LODF post-outage flows, and for
    2..``woodbury_k`` outages against the exact rank-k Woodbury update — so the
    certificate covers intact, N-1 and up to N-``woodbury_k`` topologies;
    deeper outages and islanding patterns fall through to the LP. The default
    rank 2 is right for RTS-24-sized systems (>= 3 simultaneous branch outages
    are ~6e-7 of samples, and each extra rank costs one [B, nl] @ [nl, nl]
    selector matmul on the bandwidth-bound hot path); at case300-scale ~3% of
    sampled states carry >= 3 branch outages and ``woodbury_k=4`` closes that
    miss class (every probed rank-2 miss was a benign zero-shed state —
    certified fraction 96.6% -> 99.45%, results/case300_cert_breakdown.json).
    Studies resolve the rank per system via ``hl2_nsq.default_woodbury_k``.

    ``repair_iters=0`` skips the flow-repair descent (first candidate +
    post-outage checks only; used by profiling scripts).

    ``repair_buffer`` (static): when set, the repair descent runs only on
    a top_k-compacted buffer of that many lanes instead of the full
    batch. In the plain-MC regime only ~0.4% of RTS-24 peak lanes fail
    the first flow check, so full-batch repair is ~2/3 of the whole
    certificate's cost for nothing — compaction removes it while giving
    BIT-IDENTICAL results as long as the buffer covers the needy lanes
    (row gathers are exact; the per-lane math is unchanged; pinned by
    test_lp_dcopf.py::test_certify_repair_buffer_exact). If needy lanes
    exceed the buffer, the excess lanes simply stay uncertified and fall
    to the LP — the existing max_lp overflow accounting is the safety
    net. ``None`` (default) keeps full-batch repair: REQUIRED for
    dense-outage regimes (contingency enumeration, is_boost importance
    sampling) where the needy fraction is not small — use
    ``default_repair_buffer`` for the policy.
    """
    ng = sys.n_gen
    dt = sys.bus_pd.dtype
    gen_up = 1.0 - comp_down[:, :ng].astype(dt)
    cap = gen_up @ sys.gen_pmax                        # [B]
    load_tot = jnp.sum(load_pu, axis=1)                # [B]
    deficit = jnp.maximum(load_tot - cap, 0.0)

    served = load_tot - deficit
    cand = _shed_candidate(sys, load_pu, deficit, load_tot, shed_hint)
    gen_cap = sys.gen_pmax[None, :] * gen_up               # [B, ng]
    dispatch = _dispatch_candidate(sys, gen_cap, load_pu, cand, served)

    def flows_of(shed):
        inj = (dispatch @ sys.gen_bus_onehot.T + shed @ sys.load_onehot.T
               - load_pu @ sys.load_onehot.T)          # [B, nb]
        return inj @ sys.ptdf.T                        # [B, nl]

    rate_ok = sys.br_rate[None, :] + 1e-4
    ptdf_load = sys.ptdf @ sys.load_onehot             # [nl, nd]
    flows = flows_of(cand)

    # Post-outage flows via the LODF rank-1 update, gather-free: with
    # exactly one outaged branch k, (br_down * f) = f_k * e_k, so
    # (br_down * f) @ lodf.T == lodf[:, k] * f_k — a shared matmul
    # instead of a per-lane column gather (per-lane gathers from small
    # tables dominated the certificate's cost before this rewrite).
    # For intact
    # lanes the correction is exactly zero, so ONE check covers both:
    # exact for n_out <= 1 (`eligible`). Islanding outages carry a 1e6
    # sentinel in their LODF column: any nonzero flow on the islanding
    # line fails the check and falls to the LP, while an exactly-zero
    # flow passes — correctly, since removing a zero-flow line leaves
    # the flow pattern feasible on the reduced network.
    br_down = comp_down[:, ng:].astype(dt)
    n_out = jnp.sum(br_down, axis=1)
    eligible = n_out <= 1

    def post_flows(f):
        return (f + (br_down * f) @ sys.lodf.T) * (1.0 - br_down)

    best_ok = jnp.all(jnp.abs(post_flows(flows)) <= rate_ok, axis=1)

    # Repair passes: when the first candidate congests a line, move BOTH
    # free quantities along their PTDF sensitivities — the shed pattern
    # (d f_l / d shed_i = PTDF[l, load_bus_i]) and the generator dispatch
    # (d f_l / d Pg_g = PTDF[l, gen_bus_g]) — re-balance each to its exact
    # total, and re-check. The repaired point is just another candidate:
    # if it passes, the copper bound is certified with it; otherwise the
    # state falls through to the LP. Dispatch repair is what certifies
    # multi-area systems, where the uniform-alpha dispatch forces large
    # inter-area transfers the ties cannot carry. The loop repairs the
    # POST-OUTAGE flows, so it rescues single-line-outage lanes too (they
    # were ~90% of LP-needy lanes at RTS-24 peak when only intact lanes
    # were repaired); the gradient picks up the LODF chain-rule term
    # d post_l / d f = I + e_k lodf[:,k]', i.e. w = v + br_down*(v@lodf).
    ptdf_gen = sys.ptdf @ sys.gen_bus_onehot              # [nl, ng]
    gen_cap = sys.gen_pmax[None, :] * gen_up              # [B, ng]

    def repair_loop(*lane_args):
        return _repair_descent(sys, repair_iters, rate_ok, ptdf_gen,
                               ptdf_load, *lane_args)

    if repair_iters > 0 and repair_buffer is not None:
        # Compacted repair: only lanes that failed the first check AND
        # are certificate-eligible enter the descent (same top_k
        # compaction scheme as evaluate_states_screened's LP buffer).
        B = comp_down.shape[0]
        rbuf = min(int(repair_buffer), B)
        need = (~best_ok) & eligible
        score = need.astype(jnp.int32) * (2 * B) - np.arange(
            B, dtype=np.int32)
        _, ridx = jax.lax.top_k(score, rbuf)
        rvalid = (np.arange(rbuf, dtype=np.int32) < jnp.sum(need)) \
            & need[ridx]
        okr, bshed_r, bdisp_r = repair_loop(
            load_pu[ridx], cand[ridx], dispatch[ridx], gen_cap[ridx],
            br_down[ridx], served[ridx], deficit[ridx],
            post_flows(flows)[ridx], jnp.zeros((rbuf,), bool))
        upd = rvalid & okr
        best_ok = best_ok.at[ridx].set(best_ok[ridx] | upd)
        cand = cand.at[ridx].set(
            jnp.where(upd[:, None], bshed_r, cand[ridx]))
        dispatch = dispatch.at[ridx].set(
            jnp.where(upd[:, None], bdisp_r, dispatch[ridx]))
    elif repair_iters > 0:
        best_ok, cand, dispatch = repair_loop(
            load_pu, cand, dispatch, gen_cap, br_down, served, deficit,
            post_flows(flows), best_ok)
    # The copper-sheet deficit remains a valid lower bound on any reduced
    # network (removing a line never adds capacity), and the candidate
    # achieves it with feasible post-outage flows — so the certificate
    # applies to deficit > 0 states too, intact or single-outage alike.
    certified = eligible & best_ok

    certified = certified | _woodbury_multi_ok(sys, flows, br_down, n_out,
                                               rate_ok, woodbury_k)

    return Certificate(certified=certified, deficit=deficit,
                       shed=cand, dispatch=dispatch)


def _island_rebalance(R: jax.Array, x: jax.Array,
                      caps: jax.Array, target_bus: jax.Array,
                      onehot: jax.Array) -> jax.Array:
    """Per-ISLAND exact rebalance of a nonnegative pattern ``x`` (caps
    ``caps``) so its island totals equal ``target_bus``'s island totals.

    ``R`` is the [B, nb, nb] island-indicator matrix (R[b,i,j]=1 iff i,j
    connected), ``onehot`` the [nb, k] bus scatter for x's entities, and
    ``target_bus`` a [B, nb] per-bus target whose island sums define the
    per-island totals. Same down-scale / headroom-up-scale scheme as
    :func:`_rebalance_shed`, with every total computed per island via R
    matvecs (gather-free). Requires island target <= island cap sum."""
    x_bus = x @ onehot.T                                   # [B, nb]
    tot_i = jnp.einsum("bij,bj->bi", R, x_bus)             # island totals
    tgt_i = jnp.einsum("bij,bj->bi", R, target_bus)
    resid_i = tot_i - tgt_i                                # [B, nb]
    down = jnp.maximum(tgt_i, 0.0) / jnp.maximum(tot_i, 1e-9)
    head = jnp.maximum(caps - x, 0.0)
    head_i = jnp.einsum("bij,bj->bi", R, head @ onehot.T)
    up_frac = (-resid_i) / jnp.maximum(head_i, 1e-9)
    down_e = down @ onehot                                 # [B, k] at bus
    up_e = up_frac @ onehot
    resid_e = resid_i @ onehot
    return jnp.where(resid_e >= 0, x * down_e,
                     jnp.minimum(x + head * up_e, caps))


def certify_island_pf(sys: System, comp_down: jax.Array,
                      load_pu: jax.Array,
                      repair_iters: int = 2,
                      theta_cap: float = 6.0) -> Certificate:
    """Tier-1.5 certificate: exact reduced-network DC-PF feasibility
    check, island-aware, valid for ANY outage topology.

    Runs on the (small) compacted buffer of Tier-1 misses — the deep
    multi-branch and island-forming states the PTDF/LODF/Woodbury
    certificates cannot reach (rank > woodbury_k, or a singular Woodbury
    block = islanding). Per lane, entirely batched, gather-free:

    1. **Island decomposition.** R[b,i,j] = 1 iff buses i,j are connected
       through in-service branches, by ``ceil(log2(nb))`` boolean
       squarings of the adjacency matrix (exact for any diameter; the
       5-squaring shortcut in :func:`connected_to_ref` is only safe for
       its RTS-24-class callers). All per-island aggregates are R
       matvecs — no island ids, no gathers.
    2. **Per-island copper bound.** island_deficit_i = max(0, island
       load - island capacity). The Tier-2 LP decomposes per island on
       the reduced network, and each island's DNS is >= its copper
       deficit (removing lines never adds capacity), so
       sum_islands deficit is a PROVEN lower bound on the lane's DNS —
       tighter than Tier 1's global copper bound.
    3. **Candidate at the bound.** Island-proportional shed (exactly
       island_deficit per island), locally-self-balancing dispatch
       pooled per island (the :func:`_dispatch_candidate` trick with R
       matvec pooling) — injections balance per island by construction.
    4. **Exact reduced power flow.** Solve L theta = inj with
       L = M' diag(b * br_up) M the reduced weighted Laplacian, gauge-
       fixed by the island projector: Lg = L + c * R / size. For any
       per-island-balanced injection R @ inj = 0, so Lg theta = inj has
       the SAME solutions as L theta = inj restricted to zero island
       mean — the grounding is exact, not a regularization — while Lg
       is symmetric PD with the projector's eigenvalue pinned at c
       (c = mean Laplacian diagonal keeps it in the spectrum's bulk).
       Two iterative-refinement steps against the retained Lg, then
       f = b * br_up * (M theta), checked against the ratings. A
       residual guard (|Lg theta - inj| <= 3e-5 * scale) routes any
       lane whose f32 solve did not converge to the LP instead of
       certifying on bad flows — including (self-guarding) any lane
       whose R was somehow not a true island projector.
    5. **Repair descent** (``repair_iters``): on overload, the exact
       gradient through the reduced network is one adjoint solve with
       the RETAINED factor (z = Lg^-1 M'(w * sgn_over)); shed and
       dispatch move along it and are re-balanced per island.

    A lane certifies when its candidate flows fit the ratings: DNS =
    sum of island copper deficits, proven optimal. The returned
    ``deficit``/``shed``/``dispatch`` are valid (bound, pattern) for
    UNcertified lanes too — strictly tighter fallbacks than Tier 1's
    global copper bound for overflow accounting.

    Replaces the reference's only treatment of these states — a full
    MATPOWER solve per state (mc_simulation.m:41) or silent zeros on
    failure (seqMain.m:117-126) — with a provably-exact certificate at
    O(buffer) batched cost: ~60 GFLOP of [B, nb, nb] matmuls per
    128-lane buffer at case300s — noise next to one m=792 IPM
    iteration."""
    ng, nd, nl, nb = sys.n_gen, sys.n_load, sys.n_branch, sys.n_bus
    dt = sys.bus_pd.dtype
    gen_up = 1.0 - comp_down[:, :ng].astype(dt)
    br_up = 1.0 - comp_down[:, ng:ng + nl].astype(dt)
    minc = sys.incidence                                   # [nl, nb]
    e_from = (minc > 0).astype(dt)
    e_to = (minc < 0).astype(dt)

    # 1. Island projector by exact boolean squaring.
    adj = jnp.einsum("lb,Bl,lc->Bbc", e_from, br_up, e_to)
    adj = adj + jnp.swapaxes(adj, 1, 2) + np.eye(nb, dtype=dt)[None]
    R = jnp.minimum(adj, 1.0)
    for _ in range(int(np.ceil(np.log2(max(nb, 2))))):
        R = jnp.minimum(R @ R, 1.0)
    size = jnp.sum(R, axis=2)                              # [B, nb]

    def isum(v_bus):                                       # island sums
        return jnp.einsum("bij,bj->bi", R, v_bus)

    # 2. Per-island copper bound.
    gen_cap = sys.gen_pmax[None, :] * gen_up               # [B, ng]
    cap_bus = gen_cap @ sys.gen_bus_onehot.T               # [B, nb]
    load_bus = load_pu @ sys.load_onehot.T
    icap, iload = isum(cap_bus), isum(load_bus)
    idef = jnp.maximum(iload - icap, 0.0)                  # [B, nb]
    deficit = jnp.sum(idef / jnp.maximum(size, 1.0), axis=1)

    # 3. Candidate at the bound (island-proportional shed, local-first
    # dispatch pooled per island).
    frac = idef / jnp.maximum(iload, 1e-9)                 # [B, nb]
    shed = load_pu * (frac @ sys.load_onehot)              # [B, nd]
    served_bus = load_bus - shed @ sys.load_onehot.T       # [B, nb]
    local_frac = jnp.minimum(
        served_bus / jnp.maximum(cap_bus, 1e-9), 1.0)
    disp = gen_cap * (local_frac @ sys.gen_bus_onehot)
    disp = _island_rebalance(R, disp, gen_cap, served_bus,
                             sys.gen_bus_onehot)

    # 4. Exact reduced PF with island-projector grounding.
    w = sys.b_susceptance[None, :] * br_up                 # [B, nl]
    L = jnp.einsum("lb,Bl,lc->Bbc", minc, w, minc)
    c_gauge = (jnp.einsum("bii->b", L) / nb)[:, None, None] + 1e-3
    Lg = L + c_gauge * (R / jnp.maximum(size, 1.0)[:, :, None])
    diag = jnp.diagonal(Lg, axis1=1, axis2=2)
    s = jax.lax.rsqrt(jnp.maximum(diag, 1e-30))
    Lgs = Lg * s[:, :, None] * s[:, None, :]
    chol = jnp.linalg.cholesky(Lgs)

    def pf_solve(rhs):                                     # [B, nb]
        cs = jax.vmap(lambda LL, rr: jax.scipy.linalg.cho_solve(
            (LL, True), rr))
        th = s * cs(chol, s * rhs)
        for _ in range(2):
            th = th + s * cs(chol, s * (
                rhs - jnp.einsum("bij,bj->bi", Lg, th)))
        return th

    rate_ok = sys.br_rate[None, :] + 1e-4
    inj_scale = jnp.maximum(jnp.max(jnp.abs(load_bus), axis=1), 1.0)
    # The certificate's flow point must be a feasible Tier-2 LP point,
    # so theta must fit the LP's per-bus angle boxes. theta is gauge-
    # free per island: center it mid-range per island (masked max/min
    # through R) before checking. Violations (never observed; the
    # bound is a 2x min-path overestimate) fall to the LP — soundness
    # over coverage.
    tb = jnp.minimum(sys.theta_bound, theta_cap)[None, :]
    neg_big = np.asarray(1e30, dt)

    def center_theta(theta):
        masked = theta[:, None, :] * R - neg_big * (1.0 - R)
        imax = jnp.max(masked, axis=2)
        imin = -jnp.max(-theta[:, None, :] * R - neg_big * (1.0 - R),
                        axis=2)
        return theta - 0.5 * (imax + imin)

    def check(disp_c, shed_c):
        inj = (disp_c @ sys.gen_bus_onehot.T
               + shed_c @ sys.load_onehot.T - load_bus)
        theta0 = pf_solve(inj)
        # Residual vs the RAW solution (centering shifts theta out of
        # the projector's null complement, so Lg theta' - inj picks up
        # the c * shift term by construction — not an error signal).
        resid = jnp.max(jnp.abs(
            jnp.einsum("bij,bj->bi", Lg, theta0) - inj), axis=1)
        theta = center_theta(theta0)
        f = w * (theta @ minc.T)
        ok = (jnp.all(jnp.abs(f) <= rate_ok, axis=1)
              & (resid <= 3e-5 * inj_scale)
              & jnp.all(jnp.abs(theta) <= tb, axis=1)
              & jnp.all(jnp.isfinite(f), axis=1))
        return ok, f

    best_ok, f = check(disp, shed)
    best_shed, best_disp = shed, disp

    # 5. Repair descent through the reduced network (adjoint solves
    # reuse the factor).
    cur_shed, cur_disp, cur_f = shed, disp, f
    for _ in range(repair_iters):
        over = jnp.maximum(jnp.abs(cur_f) - sys.br_rate[None, :], 0.0)
        sgn_over = jnp.sign(cur_f) * over
        z = pf_solve((w * sgn_over) @ minc)                # [B, nb]
        grad_g = z @ sys.gen_bus_onehot                    # [B, ng]
        grad_g = grad_g - jnp.mean(grad_g, axis=1, keepdims=True)
        step_g = (jnp.sum(over, axis=1) / jnp.maximum(
            jnp.max(jnp.abs(grad_g), axis=1), 1e-9))[:, None]
        disp_t = jnp.clip(cur_disp - step_g * grad_g, 0.0, gen_cap)
        grad_d = z @ sys.load_onehot                       # [B, nd]
        grad_d = grad_d - jnp.mean(grad_d, axis=1, keepdims=True)
        step_d = (deficit / jnp.maximum(
            jnp.max(jnp.abs(grad_d), axis=1), 1e-9))[:, None]
        shed_t = jnp.clip(cur_shed - step_d * grad_d, 0.0, load_pu)
        shed_t = _island_rebalance(R, shed_t, load_pu, load_bus * frac,
                                   sys.load_onehot)
        disp_t = _island_rebalance(R, disp_t, gen_cap,
                                   load_bus - shed_t @ sys.load_onehot.T,
                                   sys.gen_bus_onehot)
        ok_t, f_t = check(disp_t, shed_t)
        newly = ~best_ok & ok_t
        best_shed = jnp.where(newly[:, None], shed_t, best_shed)
        best_disp = jnp.where(newly[:, None], disp_t, best_disp)
        best_ok = best_ok | ok_t
        cur_shed, cur_disp, cur_f = shed_t, disp_t, f_t

    return Certificate(certified=best_ok, deficit=deficit,
                       shed=best_shed, dispatch=best_disp)


def calibrate_shed_hint(sys: System, batch: int = 8192,
                        seed: int = 987,
                        margin_frac: float = 0.02) -> np.ndarray | None:
    """One-time static shed-direction calibration for the certificate.

    At RTS-24 peak ~83% of deficit > 0 lanes FAIL the first post-outage
    flow check under the load-proportional shed (the forced
    all-gens-at-max dispatch overloads a line) and are then rescued by
    <= 3 repair-descent iterations — i.e. the repaired patterns are
    structurally similar across states (at RTS-24 they zero bus 7's
    share and spread it). This harvests that structure once: sample a
    deterministic calibration batch, collect the repaired sheds of
    first-check failures, and return their mean normalized pattern
    ([n_load], sums to 1). Passing it as ``shed_hint`` makes the FIRST
    pass certify 99.963% of lanes — better than proportional + 3
    repairs (99.954%), so the repair compaction buffer shrinks ~16x.
    The hint only selects WHICH optimal candidate is
    tried: certification (DNS = copper deficit with feasible flows)
    is proven per state as before, so a stale or wrong hint costs LP
    routing, never correctness.

    ``margin_frac``: the calibration repairs run against branch
    ratings tightened by this fraction, so harvested patterns clear
    the REAL limits with ~margin_frac * rate of slack. Without it the
    repair descent stops exactly at feasibility and the mean pattern
    inherits near-binding flows. The margin was introduced for a
    rounding guard band in a first-pass kernel that no longer exists;
    the default is kept so that the hints, and hence the LP routing,
    of systems where the tightened harvest succeeds stay unchanged.

    When the tightened-rating harvest rescues too few lanes to average
    (< 32 — at RTS-24 deficit optima BIND a line limit with exactly
    zero margin, so ANY tightening collapses the rescue: 275 -> 4
    lanes at margin_frac = 0.005), the calibration FALLS BACK to the
    untightened ratings (margin_frac = 0) — that restores the
    production hint (99.963% first-pass certification). Returns None
    only when even the untightened batch has too few rescued lanes.

    Regression note: an earlier revision made margin_frac = 0.02 the
    default WITHOUT this fallback, silently returning None at RTS-24 —
    the production path lost its hint (repair buffer 8x bigger, bench
    path degraded) while every estimate stayed correct. Pinned by
    tests/test_lp_dcopf.py::test_shed_hint_calibration_and_equivalence.
    """
    from powersystemsreliabilityassessment.sampling.state import (
        sample_states)
    sys_tight = dataclasses.replace(
        sys, br_rate=sys.br_rate * (1.0 - margin_frac))
    key = jax.random.key(seed)
    down = sample_states(key, sys.unavail, sys.always_up_nsq, batch)
    load = jnp.broadcast_to(sys.load_pd[None, :], (batch, sys.load_pd
                                                   .shape[0]))
    r0 = certify_states(sys_tight, down, load, repair_iters=0)
    r3 = certify_states(sys_tight, down, load, repair_iters=6)
    rescued = np.asarray(r3.certified & ~r0.certified)
    if int(rescued.sum()) < 32:
        if margin_frac > 0.0:
            return calibrate_shed_hint(sys, batch, seed, margin_frac=0.0)
        return None
    shed = np.asarray(r3.shed, np.float64)[rescued]
    pat = (shed / np.maximum(shed.sum(axis=1, keepdims=True),
                             1e-9)).mean(axis=0)
    s = float(pat.sum())
    if not np.isfinite(s) or s <= 0:
        return None
    return (pat / s).astype(np.float32)


def overgen_infeasible(sys: System, comp_down: jax.Array,
                       load_pu: jax.Array, compat: CompatFlags) -> jax.Array:
    """[B] bool: the state's LP has no feasible point because committed
    minimum generation exceeds total demand.

    Only possible with ``compat.enforce_pmin`` (the reference's MATPOWER
    case carries nonzero Pmin; ``runopf`` fails on such states and the
    try/catch records zero curtailment, seqMain.m:117-126). With the
    default ``enforce_pmin=False`` every state is feasible and this is
    constant-False.
    """
    if not compat.enforce_pmin:
        return jnp.zeros_like(comp_down[:, 0], dtype=bool)
    ng = sys.n_gen
    dt = sys.bus_pd.dtype
    gen_up = 1.0 - comp_down[:, :ng].astype(dt)
    has_cap = (sys.gen_pmax > 0).astype(dt)
    pmin_committed = (gen_up * has_cap) @ sys.gen_pmin
    return pmin_committed > jnp.sum(load_pu, axis=1) + 1e-9


def baseline_report(sys: System) -> dict:
    """Intact-system sanity check before an MC study starts.

    The reference runs a full ``runopf`` on the intact network and prints
    its success before the loop (nsqMain.m:188-198). A jitted 1-lane OPF
    would cost a fresh compile of its own, so this is the
    host-side float64 analog: capacity margin vs peak load, plus the max
    intact-network line loading of the proportional (copper) dispatch
    through the PTDF. A congested proportional dispatch is only a
    warning (the OPF can redispatch); capacity below peak load means the
    system sheds even fully intact and is flagged.
    """
    cap = np.asarray(sys.gen_pmax, np.float64)
    load = np.asarray(sys.load_pd, np.float64)
    ptdf = np.asarray(sys.ptdf, np.float64)
    cg = np.asarray(sys.gen_bus_onehot, np.float64)
    cd = np.asarray(sys.load_onehot, np.float64)
    rate = np.asarray(sys.br_rate, np.float64)
    total_cap, total_load = cap.sum(), load.sum()
    disp = cap * (total_load / max(total_cap, 1e-12))
    inj = cg @ disp - cd @ load
    loading = np.abs(ptdf @ inj) / np.maximum(rate, 1e-12)
    base = float(sys.base_mva)
    return {
        "capacity_mw": total_cap * base,
        "peak_load_mw": total_load * base,
        "margin_mw": (total_cap - total_load) * base,
        "max_line_loading": float(loading.max()),
        "capacity_feasible": bool(total_cap >= total_load),
    }


def print_baseline(sys: System) -> dict:
    r = baseline_report(sys)
    status = ("ok" if r["capacity_feasible"]
              else "INFEASIBLE (sheds even intact)")
    print(f"baseline: intact capacity {r['capacity_mw']:.0f} MW vs peak "
          f"{r['peak_load_mw']:.0f} MW (margin {r['margin_mw']:.0f} MW, "
          f"{status}); proportional-dispatch max line loading "
          f"{100 * r['max_line_loading']:.0f}%")
    return r


def _solve_one(sys: System, comp_down: jax.Array, load_pu: jax.Array,
               compat: CompatFlags, ipm: IPMConfig):
    ng, nd, nl = sys.n_gen, sys.n_load, sys.n_branch
    up = 1.0 - comp_down.astype(sys.bus_pd.dtype)
    gen_up, br_up = up[:ng], up[ng:ng + nl]
    c, A, b, l, u = build_state_lp(sys, gen_up, br_up, load_pu, compat,
                                   ipm.theta_max)
    sol = lp_ipm.solve_box_lp(c, A, b, l, u, ipm)
    shed = sol.x[ng:ng + nd]
    return shed, sol.x[:ng], sol.primal_residual


def _solve_batch(sys: System, comp_down: jax.Array, load_pu: jax.Array,
                 compat: CompatFlags, ipm: IPMConfig):
    """Batched LP path: the dense materialized-A IPM for m up to
    ``lp_ipm_batched._BLOCKED_MAX_M``, the structured block-Schur
    operator beyond. No padding: any batch size B runs as is."""
    from powersystemsreliabilityassessment.engines import lp_ipm_batched

    ng, nd, nl = sys.n_gen, sys.n_load, sys.n_branch
    n_vars = ng + nd + nl + sys.n_bus
    up = 1.0 - comp_down.astype(sys.bus_pd.dtype)
    gen_up, br_up = up[:, :ng], up[:, ng:ng + nl]
    if (ipm.structured_gram
            and sys.n_bus + nl > lp_ipm_batched._BLOCKED_MAX_M):
        # Large-m path with the STRUCTURED constraint operator
        # (make_dc_linops): the block assembly cuts the gram's FLOPs
        # ~7x and drops the [B, m, n] residency. Scoped to
        # m > _BLOCKED_MAX_M so the small/mid-m golden-pinned numerics
        # keep the dense rounding exactly.
        c, b, l, u, colscale = build_state_lp_vectors(
            sys, gen_up, br_up, load_pu, compat, ipm.theta_max)
        lops = make_dc_linops(sys, colscale[:, :ng], br_up)
        sol = lp_ipm_batched.solve_box_lp_ops(c, b, l, u, lops, ipm)
    else:
        c, A, b, l, u = jax.vmap(
            lambda gu, bu, ld: build_state_lp(sys, gu, bu, ld, compat,
                                              ipm.theta_max))(
            gen_up, br_up, load_pu)
        sol = lp_ipm_batched.solve_box_lp_batched(c, A, b, l, u, ipm)
    shed = sol.x[:, ng:ng + nd]
    # Conservative lane-quality score: primal infeasibility plus the
    # duality-gap estimate (2n*mu) — a primal-feasible but non-optimal
    # iterate has small rp but large gap.
    quality = sol.primal_residual + 2 * n_vars * sol.duality_gap
    return shed, sol.x[:, :ng], quality


def _finalize(sys: System, compat: CompatFlags, shed, pg, res, comp_down,
              load_pu, woodbury_k: int = 2) -> EvalResult:
    """Apply the exactness certificate and the reference noise thresholds."""
    cert = certify_states(sys, comp_down, load_pu, shed_hint=shed,
                          woodbury_k=woodbury_k)
    shed = jnp.where(cert.certified[:, None], cert.shed, shed)
    pg = jnp.where(cert.certified[:, None], cert.dispatch, pg)

    base = sys.base_mva
    dns = jnp.where(cert.certified, cert.deficit * base,
                    jnp.sum(shed, axis=1) * base)
    # Quality guard: a lane whose LP left a large primal infeasibility OR
    # duality gap is untrustworthy — degrade to the copper-sheet lower
    # bound (and the certificate's balanced pattern) instead of
    # propagating garbage. The score stays exposed in EvalResult
    # (primal_residual field) for monitoring. (The reference silently
    # records ZERO on solver failure, seqMain.m:117-126; a bound is
    # strictly better and still flagged.)
    # NaN-safe: a lane whose IPM iterate blew up entirely has res = NaN,
    # and ``NaN > 5e-3`` is False — write the guard as ~(res <= tol) so
    # non-finite scores degrade too (observed: a double-line islanding
    # state on the CPU float32 path returned NaN through a False guard).
    bad = (~cert.certified) & ~(res <= 5e-3)
    dns = jnp.where(bad, cert.deficit * base, dns)
    shed = jnp.where(bad[:, None], cert.shed, shed)
    nodal = (shed * base) @ sys.load_onehot.T  # [B, nb]

    dns = jnp.where(dns < compat.dns_noise_floor_mw, 0.0, dns)
    nodal = jnp.where(
        (nodal > compat.nodal_noise_threshold_mw)
        & (dns[:, None] > 0), nodal, 0.0)
    failure = dns > compat.nsq_fail_flag_threshold_mw
    return EvalResult(dns_mw=dns, nodal_mw=nodal, failure=failure,
                      primal_residual=res, gen_dispatch=pg,
                      infeasible=overgen_infeasible(sys, comp_down, load_pu,
                                                    compat))


@partial(jax.jit, static_argnames=("compat", "ipm", "woodbury_k"))
def evaluate_states(sys: System, comp_down: jax.Array, load_pu: jax.Array,
                    compat: CompatFlags = CompatFlags(),
                    ipm: IPMConfig = IPMConfig(),
                    woodbury_k: int = 2) -> EvalResult:
    """Evaluate a batch of states: IPM on every lane + certificate override.

    Args:
      comp_down: [B, n_comp] component failure indicator (1 = failed, the
        reference convention).
      load_pu:   [B, n_load] per-load-bus demand in p.u. for each state.

    Returns MW quantities with the reference's noise thresholds applied
    (mc_simulation.m:57-59, :86).
    """
    extra_nodal = None
    if compat.island_blackout:
        comp_down, load_pu, extra_nodal = apply_island_blackout(
            sys, comp_down, load_pu)
    shed, pg, res = _solve_batch(sys, comp_down, load_pu, compat, ipm)
    out = _finalize(sys, compat, shed, pg, res, comp_down, load_pu,
                    woodbury_k)
    if extra_nodal is not None:
        dns = out.dns_mw + jnp.sum(extra_nodal, axis=1)
        nodal = out.nodal_mw + extra_nodal
        dns = jnp.where(dns < compat.dns_noise_floor_mw, 0.0, dns)
        out = out._replace(
            dns_mw=dns, nodal_mw=nodal,
            failure=dns > compat.nsq_fail_flag_threshold_mw)
    return out


def default_repair_buffer(batch: int,
                          outage_boost: float = 1.0,
                          hinted: bool = False) -> int | None:
    """Compacted-repair buffer policy for ``certify_states``.

    Plain-MC regime at RTS-24 peak: ~7.0% of lanes fail the first post-outage
    flow check (18,446 of 262144 counted) — almost all of them deficit > 0
    states, whose forced all-gens-at-max dispatch overloads a line under the
    proportional shed until the repair descent moves the shed pattern (it
    rescues 99.5% of them). The needy fraction is therefore ~LOLP at the study
    load level (~8.5% at RTS-24 peak), NOT the ~0.4% residual that reaches the
    LP after repair — an earlier ``batch // 64`` policy conflated the two and
    silently degraded ~5.4% of bench-config lanes to their copper bounds via
    LP-buffer overflow. ``batch // 8`` covers the counted need with ~1.7x
    headroom, and the repair descent runs on an eighth of the lanes.
    Dense-outage regimes (``outage_boost > 1`` importance sampling; contingency
    enumeration calls keep the ``None`` default directly) must repair
    full-batch — their needy fraction is larger still, and overflowed lanes
    would all fall to the LP buffer instead.

    ``hinted=True``: the caller passes a ``calibrate_shed_hint``
    pattern, which collapses the first-check failures to ~0.04% of
    lanes (96 of 262144 measured) — ``batch // 64`` then still leaves
    ~40x headroom.
    """
    if outage_boost > 1.0:
        return None
    return min(batch, max(2048, batch // (64 if hinted else 8)))


def default_pf_buffer(sys: System, batch: int) -> int | None:
    """Tier-1.5 (``certify_island_pf``) buffer policy.

    Enabled only where it pays: systems on the large-m LP path
    (m > 336), where one LP lane is expensive and the Tier-1 miss
    class is dominated by deep multi-branch / islanding states the PF
    certificate closes (~85% of misses at case300s, every one a benign
    zero-shed state — results/r4_miss.json). Small/mid systems keep
    ``None``: their misses are ~0.04% and the dense IPM clears them
    cheaply, so an extra [B, nb, nb] tier would cost more than it
    saves. 256 lanes is ~5x the counted plain-MC miss rate at
    case300s (48/8192); overflow beyond it just rides the
    existing LP-buffer accounting."""
    if sys.n_bus + sys.n_branch <= 336:
        return None
    return min(batch, 256)


@partial(jax.jit, static_argnames=("compat", "ipm", "max_lp", "nodal_mode",
                                   "repair_buffer", "woodbury_k",
                                   "pf_buffer"))
def evaluate_states_screened(sys: System, comp_down: jax.Array,
                             load_pu: jax.Array, max_lp: int,
                             compat: CompatFlags = CompatFlags(),
                             ipm: IPMConfig = IPMConfig(),
                             nodal_mode: str = "lp",
                             repair_buffer: int | None = None,
                             woodbury_k: int = 2,
                             shed_hint: jax.Array | None = None,
                             pf_buffer: int | None = None):
    """Screened evaluation: run the LP only on states that need it.

    States certified at ZERO deficit are resolved by Tier 1 alone; states
    with a positive deficit or a failed certificate are compacted into a
    fixed-size buffer of ``max_lp`` lanes and solved by the IPM (positive-
    deficit states still get the certificate override for the total, but
    their nodal split comes from the LP's interior solution, matching the
    reference's MIPS behavior on degenerate optima).

    ``nodal_mode="proportional"`` additionally skips the LP for CERTIFIED
    positive-deficit states: their total DNS is already provably exact and
    their nodal split becomes the certificate's load-proportional pattern
    (one valid point of the degenerate optimal face). All aggregate
    indices (EDNS/LOLE/EENS/PLC/component importance) are unchanged; only
    the per-bus split of the shed differs. This cuts the LP fraction from
    ~10% to ~1-2% of states at peak load.

    Returns ``(EvalResult, n_overflow)`` where ``n_overflow`` counts states
    that needed the LP but did not fit in the buffer (they fall back to the
    Tier-1 bound with a load-proportional nodal pattern — statistically a
    tiny, logged perturbation; pick ``max_lp`` so this is ~never hit).

    ``repair_buffer`` (static) is forwarded to ``certify_states``:
    compacted certificate repair for sparse-outage (plain-MC) regimes —
    see ``default_repair_buffer``. ``None`` keeps full-batch repair.

    ``shed_hint``: [n_load] static shed-direction pattern from
    ``calibrate_shed_hint`` (broadcast per lane); makes the first
    certificate pass near-complete so ``repair_buffer`` can shrink
    (``default_repair_buffer(hinted=True)``).
    """
    extra_nodal = None
    if compat.island_blackout:
        comp_down, load_pu, extra_nodal = apply_island_blackout(
            sys, comp_down, load_pu)
        compat = dataclasses.replace(compat, island_blackout=False)

    hint_b = (None if shed_hint is None else jnp.broadcast_to(
        shed_hint[None, :], load_pu.shape))
    pre = certify_states(sys, comp_down, load_pu, shed_hint=hint_b,
                         repair_buffer=repair_buffer,
                         woodbury_k=woodbury_k)
    if nodal_mode == "proportional":
        need_lp = ~pre.certified
    else:
        need_lp = ~(pre.certified & (pre.deficit <= 0))

    if pf_buffer:
        # Tier 1.5: exact reduced-network PF certificate on the
        # compacted Tier-1 miss buffer — closes the deep-multi-branch
        # and islanding miss classes Woodbury cannot reach (at case300s
        # they were ~85% of LP-routed lanes, every one a benign
        # zero-shed state — results/r4_miss.json), so max_lp shrinks.
        B_pf = need_lp.shape[0]
        kpf = min(int(pf_buffer), B_pf)
        score_pf = need_lp.astype(jnp.int32) * (2 * B_pf) - np.arange(
            B_pf, dtype=np.int32)
        _, pidx = jax.lax.top_k(score_pf, kpf)
        pvalid = (np.arange(kpf, dtype=np.int32) < jnp.sum(need_lp)) \
            & need_lp[pidx]
        sub = certify_island_pf(sys, comp_down[pidx], load_pu[pidx],
                                theta_cap=ipm.theta_max)
        vc = pvalid[:, None]
        # The island-copper bound/pattern is valid for UNcertified
        # buffer lanes too — a tighter overflow fallback than Tier 1's
        # global copper bound.
        pre = Certificate(
            certified=pre.certified.at[pidx].set(
                pre.certified[pidx] | (pvalid & sub.certified)),
            deficit=pre.deficit.at[pidx].set(
                jnp.where(pvalid,
                          jnp.maximum(sub.deficit, pre.deficit[pidx]),
                          pre.deficit[pidx])),
            shed=pre.shed.at[pidx].set(
                jnp.where(vc, sub.shed, pre.shed[pidx])),
            dispatch=pre.dispatch.at[pidx].set(
                jnp.where(vc, sub.dispatch, pre.dispatch[pidx])))
        if nodal_mode == "proportional":
            need_lp = ~pre.certified
        else:
            need_lp = ~(pre.certified & (pre.deficit <= 0))

    # Compaction via top_k: scores rank needy lanes first, each group in
    # ascending lane order. The needy prefix of `idx` matches
    # jnp.nonzero(size=max_lp, fill_value=0) exactly; the FILL slots differ
    # (they hold live non-needy lane indices, not 0), so idx/sub_res are
    # only meaningful under the `valid` mask below — every consumer here
    # guards with it. top_k lowers to a sort instead of nonzero's
    # cumsum+scatter.
    B_pad = need_lp.shape[0]
    k_eff = min(max_lp, B_pad)          # top_k requires k <= batch
    score = need_lp.astype(jnp.int32) * (2 * B_pad) - np.arange(
        B_pad, dtype=np.int32)
    _, idx = jax.lax.top_k(score, k_eff)
    if k_eff < max_lp:
        idx = jnp.concatenate(
            [idx, np.zeros((max_lp - k_eff,), np.int32)])
    valid = (np.arange(max_lp, dtype=np.int32) < jnp.sum(need_lp)) \
        & need_lp[idx]

    sub_res = evaluate_states(sys, comp_down[idx], load_pu[idx], compat, ipm,
                              woodbury_k)

    base = sys.base_mva
    # Tier-1 fallback for every lane (exact for certified lanes; the best
    # available bound for overflow lanes).
    dns = pre.deficit * base
    nodal = (pre.shed * base) @ sys.load_onehot.T
    pg = pre.dispatch
    res0 = jnp.zeros_like(dns)

    vcol = valid[:, None]
    dns = dns.at[idx].set(jnp.where(valid, sub_res.dns_mw, dns[idx]))
    nodal = nodal.at[idx].set(jnp.where(vcol, sub_res.nodal_mw, nodal[idx]))
    pg = pg.at[idx].set(jnp.where(vcol, sub_res.gen_dispatch, pg[idx]))
    res = res0.at[idx].set(jnp.where(valid, sub_res.primal_residual, 0.0))

    if extra_nodal is not None:
        dns = dns + jnp.sum(extra_nodal, axis=1)
        nodal = nodal + extra_nodal

    dns = jnp.where(dns < compat.dns_noise_floor_mw, 0.0, dns)
    nodal = jnp.where(
        (nodal > compat.nodal_noise_threshold_mw) & (dns[:, None] > 0),
        nodal, 0.0)
    failure = dns > compat.nsq_fail_flag_threshold_mw
    n_overflow = jnp.maximum(jnp.sum(need_lp) - max_lp, 0)
    return EvalResult(dns_mw=dns, nodal_mw=nodal, failure=failure,
                      primal_residual=res, gen_dispatch=pg,
                      infeasible=overgen_infeasible(sys, comp_down, load_pu,
                                                    compat)), n_overflow


def copper_sheet_bound(sys: System, comp_down: jax.Array,
                       load_pu: jax.Array) -> jax.Array:
    """Lower bound on DNS (MW): generation-capacity deficit ignoring the
    network. Used as a sanity invariant in tests (LP shed >= this bound)."""
    up = 1.0 - comp_down[..., : sys.n_gen].astype(sys.gen_pmax.dtype)
    cap = up @ sys.gen_pmax
    load = jnp.sum(load_pu, axis=-1)
    return jnp.maximum(load - cap, 0.0) * sys.base_mva
