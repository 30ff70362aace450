"""All-matmul blocked Cholesky + explicit blocked triangular inverse
for the large-m (m > 336) batched IPM path.

Why this exists: a single-rhs triangular solve is an m-step sequential
loop, and the IPM needs ~12 of them per iteration at m = 792. This
module spends the same O(m^3) flops in matmul-shaped ops instead:

  * `factor`: fused right-looking panel factorization + explicit
    blocked L^-1 with 128-wide panels — the O(m^3) bulk (trailing
    updates and the forward-substitution fill) becomes [B, r, 128] @
    [B, 128, r] matmuls; only the per-panel diagonal-block chol and one
    128-rhs identity solve are sequential.
  * `solve`: every subsequent cho_solve is then two batched matvecs
    (bandwidth-bound: one read of L^-1 per apply), with iterative
    refinement in the caller unchanged.

Numerics: explicit triangular inversion amplifies error by ~cond(L)
relative to substitution, but this path only ever sees EQUILIBRATED
normal matrices (unit diagonal, +1e-6 ridge) and every consumer already
runs 2-step iterative refinement against the retained matrix plus the
IPM's best-iterate/quality-guard/escalation safety net — the same
ladder that covers the f32 Cholesky itself. Verified against the f64
HiGHS oracle by the case300 stress suite (scripts/parity_case300.py).

Whether this beats ``jnp.linalg.cholesky`` (cuSOLVER's batched factor)
on a GPU is not measured yet; smaller systems use the latter directly
(engines/lp_ipm_batched._make_chol_ops).

Replaces (at case300 scale) the reference's per-state MATPOWER MIPS
factorization (mc_simulation.m:41, mpoption 'pdipm').
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

BS = 128  # panel width


def _pad_spd(M: jax.Array, bs: int = BS):
    """Pad [B, m, m] SPD to a multiple of bs with an identity corner."""
    m = M.shape[1]
    mp = ((m + bs - 1) // bs) * bs
    if mp == m:
        return M, m
    pad = mp - m
    B = M.shape[0]
    M = jnp.pad(M, ((0, 0), (0, pad), (0, pad)))
    eye_tail = jnp.zeros((mp, mp), M.dtype).at[
        np.arange(m, mp), np.arange(m, mp)].set(1.0)
    return M + eye_tail[None], m


def factor(M: jax.Array, bs: int = BS):
    """Factor an SPD batch for repeated `solve` calls.

    Returns (Linv [B, mp, mp], m) — the explicit inverse Cholesky
    factor of the padded matrix.

    Fused factorization + inversion (round 4): each bs-wide diagonal block L_kk
    is inverted ONCE (the only triangular solve left), and that inverse serves
    both the panel computation (P_k = A[tr, k] L_kk^-T — a matmul instead of a
    loop-lowered bs-step triangular solve with up to m-bs rhs) and the explicit
    block-inverse fill. This cuts the sequential loop-lowered ops per factor
    from 3 to 2 per panel (chol + one bs-rhs solve), which is what the
    latency-bound rescue sub-solve pays 16x per LP. Numerics: the
    panel-by-inverse product adds the same ~cond(L_kk) rounding class as the
    explicit inverse the path already uses; the callers' iterative refinement +
    best-iterate + quality-guard ladder covers it (tests/test_xla_chol.py pins
    refined accuracy, the case300 stress suite pins end-to-end DNS).
    """
    A, m = _pad_spd(M, bs)
    mp = A.shape[1]
    nblk = mp // bs
    B = A.shape[0]
    eye = jnp.eye(bs, dtype=A.dtype)
    L = jnp.zeros_like(A)
    inv_diag = []
    for k in range(nblk):
        lo, hi = k * bs, (k + 1) * bs
        Lkk = jnp.linalg.cholesky(A[:, lo:hi, lo:hi])
        inv_diag.append(jax.lax.linalg.triangular_solve(
            Lkk, jnp.broadcast_to(eye, (B, bs, bs)), left_side=True,
            lower=True))
        L = L.at[:, lo:hi, lo:hi].set(Lkk)
        if hi < mp:
            # P_k = A[tr, k] L_kk^-T — one batched matmul.
            Pk = jnp.einsum("bik,bjk->bij", A[:, hi:, lo:hi], inv_diag[k])
            L = L.at[:, hi:, lo:hi].set(Pk)
            A = A.at[:, hi:, hi:].add(
                -jnp.einsum("bik,bjk->bij", Pk, Pk))
    # Explicit L^-1 by block forward substitution, reusing inv_diag
    # (Linv[i, j] = -Linv[i, i] @ sum_{j<=k<i} L[i, k] Linv[k, j];
    # all matmuls from here, one per row block).
    Linv = jnp.zeros_like(L)
    Linv = Linv.at[:, :bs, :bs].set(inv_diag[0])
    for i in range(1, nblk):
        lo, hi = i * bs, (i + 1) * bs
        S = jnp.einsum("bik,bkj->bij", L[:, lo:hi, :lo], Linv[:, :lo, :lo])
        Linv = Linv.at[:, lo:hi, :lo].set(
            -jnp.einsum("bik,bkj->bij", inv_diag[i], S))
        Linv = Linv.at[:, lo:hi, lo:hi].set(inv_diag[i])
    return Linv, m


def inv_spd_equilibrated(M: jax.Array, delta: float = 1e-6) -> jax.Array:
    """Explicit inverse of an SPD batch, Jacobi-equilibrated + ridged.

    Returns ``approx (M + delta*diag(M))^-1`` as a dense [B, m, m]
    array: M is scaled to unit diagonal, ridged by ``delta * I``,
    inverted explicitly through this module's blocked factor, and
    scaled back.

    The perturbation (ridge + explicit-inverse rounding)
    is removed by the caller's iterative refinement against the TRUE
    operator; see lp_ipm_batched's structured-normal solve.
    """
    m = M.shape[1]
    diag = jnp.diagonal(M, axis1=1, axis2=2)
    s = jax.lax.rsqrt(jnp.maximum(diag, 1e-30))
    eye = np.eye(m, dtype=M.dtype)
    Ms = M * s[:, :, None] * s[:, None, :] + np.asarray(delta, M.dtype) * eye
    Linv, _ = factor(Ms)
    Minv_s = jnp.einsum("bki,bkj->bij", Linv, Linv)[:, :m, :m]
    return Minv_s * s[:, :, None] * s[:, None, :]


def solve(F, r: jax.Array) -> jax.Array:
    """M^-1 r via two batched matvecs with L^-1 (no refinement here —
    callers refine against the retained M exactly as before)."""
    Linv, m = F
    mp = Linv.shape[1]
    if mp != m:
        r = jnp.pad(r, ((0, 0), (0, mp - m)))
    t = jnp.einsum("bij,bj->bi", Linv, r)
    y = jnp.einsum("bji,bj->bi", Linv, t)
    return y[:, :m]
