"""Unit tests for the all-matmul blocked Cholesky / explicit inverse
used by the large-m (m > 336) batched IPM path (ops/xla_chol.py).

Correctness contract: `factor`+`solve` must reproduce a float64
M^-1 r to f32 iterative-refinement quality on equilibrated SPD
matrices of the kind the IPM produces (unit diagonal + ridge), for
sizes both at and off the 128 panel multiple.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from powersystemsreliabilityassessment.ops import xla_chol


def _spd_batch(B, m, seed=0, cond=1e4):
    """Equilibrated SPD batch: unit diagonal, controlled conditioning."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, m, m))
    # SPD with spread singular values, then Jacobi-equilibrated.
    M = np.einsum("bik,bjk->bij", A, A) / m
    M += np.eye(m) * (np.trace(M, axis1=1, axis2=2) / (m * cond))[:, None,
                                                                  None]
    d = 1.0 / np.sqrt(np.einsum("bii->bi", M))
    M = M * d[:, :, None] * d[:, None, :]
    M += 1e-6 * np.eye(m)
    return M


@pytest.mark.parametrize("m", [64, 128, 200, 384])
def test_factor_matches_xla_cholesky(m):
    # Parity of the PRODUCTION factor against numpy's f64 Cholesky:
    # factor returns the explicit inverse factor, so recover
    # L = Linv^-1 (exactly triangular) and compare. This tests the one
    # implementation the IPM actually runs (a separate blocked copy
    # once drifted from factor's fused numerics).
    M = _spd_batch(3, m, seed=m)
    Linv, m_out = xla_chol.factor(jnp.asarray(M, jnp.float32))
    assert m_out == m
    Linv = np.asarray(Linv, np.float64)
    # strictly upper part must be exactly zero
    assert np.all(np.triu(Linv, 1) == 0.0)
    L = np.linalg.inv(Linv)[:, :m, :m]
    ref = np.linalg.cholesky(M)
    np.testing.assert_allclose(L, ref, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("m", [96, 256, 392])
def test_factor_solve_inverts(m):
    M = _spd_batch(4, m, seed=100 + m)
    r = np.random.default_rng(m).standard_normal((4, m))
    F = xla_chol.factor(jnp.asarray(M, jnp.float32))
    y = np.asarray(xla_chol.solve(F, jnp.asarray(r, jnp.float32)),
                   np.float64)
    ref = np.linalg.solve(M, r[..., None])[..., 0]
    # one refinement step, as every caller applies
    y1 = y + np.asarray(
        xla_chol.solve(F, jnp.asarray(
            r - np.einsum("bij,bj->bi", M, y), jnp.float32)), np.float64)
    err = np.abs(y1 - ref).max() / max(np.abs(ref).max(), 1.0)
    assert err < 5e-5


def test_pad_identity_isolated():
    # The pad block must not couple into the real block: solving with a
    # padded factor equals solving the unpadded system.
    m = 130  # forces a 126-wide pad
    M = _spd_batch(2, m, seed=7)
    r = np.random.default_rng(7).standard_normal((2, m))
    F = xla_chol.factor(jnp.asarray(M, jnp.float32))
    assert F[0].shape[1] == 256
    y = np.asarray(xla_chol.solve(F, jnp.asarray(r, jnp.float32)),
                   np.float64)
    y = y + np.asarray(
        xla_chol.solve(F, jnp.asarray(
            r - np.einsum("bij,bj->bi", M, y), jnp.float32)), np.float64)
    ref = np.linalg.solve(M, r[..., None])[..., 0]
    np.testing.assert_allclose(y, ref, atol=2e-3, rtol=2e-3)
