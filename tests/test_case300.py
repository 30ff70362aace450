"""case300-scale (m = 792) LP-path regression: the large-m XLA solver
with iterative refinement + polished warm restart must match the float64
HiGHS oracle on concentrated deep contingencies.

This is the m > _BLOCKED_MAX_M branch of lp_ipm_batched._make_chol_ops
(cases.case300s; SURVEY §2.4 loadcase scale obligation). Without the
refinement/restart rescue these lanes either stall at hidden 8-60 MW
objective errors or trip the 5e-3 quality guard and degrade to zero
copper bounds while the true shed is transmission-limited and positive
(measured in scripts/parity_case300.py).
"""
import numpy as np
import jax.numpy as jnp
import pytest
from scipy.optimize import linprog

from powersystemsreliabilityassessment.core import cases
from powersystemsreliabilityassessment.core.system import build_system
from powersystemsreliabilityassessment.engines import lp_ipm_batched
from powersystemsreliabilityassessment.engines.dcopf import (
    build_state_lp, make_dc_linops)
from powersystemsreliabilityassessment.utils.config import (
    CompatFlags, IPMConfig)


def _concentrated_states(case, n):
    """Deep gen+line outages inside ONE RTS-24 tile of the 300-bus system
    (the scripts/parity_case300.py 'concentrated' recipe, made
    deterministic): the k largest units of one area go down, so the area
    deficit exceeds the ring import and the shed is transmission-limited
    — the hardest conditioning regime for the f32 normal equations."""
    ng, nl = case.n_gen, case.n_branch
    area_ng, area_nl = 33, 38
    states = np.zeros((n, ng + nl), np.float32)
    for i in range(n):
        a = 2 * i + 1                  # distinct areas
        pm = case.gen_pmax[a * area_ng:(a + 1) * area_ng]
        gs = np.argsort(pm)[-(9 + i):]  # 9..12 largest units
        states[i, a * area_ng + gs] = 1.0
        states[i, ng + a * area_nl + np.array([3 + i, 17])] = 1.0
    return states


@pytest.fixture(scope="module")
def deep_lps():
    """4 concentrated deep-contingency LPs at m=792 + their f64 optima."""
    case = cases.case300s()
    sys_ = build_system(case)
    ng, nd = int(sys_.n_gen), int(sys_.load_pd.shape[0])
    base = float(sys_.base_mva)
    compat, ipm = CompatFlags(), IPMConfig()
    load = jnp.asarray(sys_.load_pd, jnp.float32)

    states = _concentrated_states(case, 4)
    lps = [build_state_lp(sys_, jnp.asarray(1.0 - s[:ng], jnp.float32),
                          jnp.asarray(1.0 - s[ng:], jnp.float32),
                          load, compat, ipm.theta_max) for s in states]
    c = jnp.stack([t[0] for t in lps])
    A = jnp.stack([t[1] for t in lps])
    b = jnp.stack([t[2] for t in lps])
    l = jnp.stack([t[3] for t in lps])
    u = jnp.stack([t[4] for t in lps])
    assert A.shape[1] > lp_ipm_batched._BLOCKED_MAX_M  # the XLA branch

    # f64 oracle on the SAME f32-built LP data (scipy is numpy-f64).
    refs = []
    for i in range(len(states)):
        r = linprog(np.asarray(c[i], np.float64),
                    A_eq=np.asarray(A[i], np.float64),
                    b_eq=np.asarray(b[i], np.float64),
                    bounds=list(zip(np.asarray(l[i], np.float64),
                                    np.asarray(u[i], np.float64))),
                    method="highs")
        assert r.status == 0, r.message
        refs.append(float(np.sum(r.x[ng:ng + nd])) * base)
    refs = np.asarray(refs)
    assert (refs > 1.0).any()  # the recipe produced real shed
    return c, A, b, l, u, refs, ng, nd, base


def _check(sol, refs, ng, nd, base):
    dns = np.asarray(jnp.sum(sol.x[:, ng:ng + nd], axis=1)) * base
    err = np.abs(dns - refs)
    # The f32 floor on these deep lanes is ~0.7 MW (vs 7.7 MW without the
    # rescue and 42-324 MW of true shed); lanes must not trip the 5e-3
    # quality guard (that would silently degrade them to zero bounds).
    assert err.max() < 1.5, (dns, refs)
    assert np.asarray(sol.primal_residual).max() < 5e-3


def test_large_m_ipm_matches_f64_oracle(deep_lps):
    c, A, b, l, u, refs, ng, nd, base = deep_lps
    sol = lp_ipm_batched.solve_box_lp_batched(c, A, b, l, u, IPMConfig())
    _check(sol, refs, ng, nd, base)


def test_large_m_compacted_restart_adversarial(deep_lps):
    """restart_compact smaller than the number of HARD lanes: the two
    left-behind deep lanes must still be rescued by the cond-gated
    full-batch escalation passes (the safety net for batches where more
    than restart_compact lanes are hard)."""
    c, A, b, l, u, refs, ng, nd, base = deep_lps
    ipm = IPMConfig(restart_compact=2)
    sol = lp_ipm_batched.solve_box_lp_batched(c, A, b, l, u, ipm)
    _check(sol, refs, ng, nd, base)


def _state_scalings(case, sys_, n):
    states = _concentrated_states(case, n)
    ng = case.n_gen
    gen_up = jnp.asarray(1.0 - states[:, :ng], jnp.float32)
    br_up = jnp.asarray(1.0 - states[:, ng:], jnp.float32)
    has_cap = (np.asarray(sys_.gen_pmax) > 0).astype(np.float32)
    return gen_up * has_cap[None, :], br_up


def test_structured_linops_match_dense(deep_lps):
    """make_dc_linops products == the materialized build_state_lp tensor
    (same states as the deep-contingency fixture)."""
    c, A, b, l, u, refs, ng, nd, base = deep_lps
    case = cases.case300s()
    sys_ = build_system(case)
    gen_col, br_up = _state_scalings(case, sys_, A.shape[0])
    ops = make_dc_linops(sys_, gen_col, br_up)

    rng = np.random.default_rng(11)
    B, m, n = A.shape
    v = jnp.asarray(rng.normal(size=(B, n)), jnp.float32)
    y = jnp.asarray(rng.normal(size=(B, m)), jnp.float32)
    w = jnp.asarray(rng.uniform(0.1, 10.0, size=(B, n)), jnp.float32)

    Ad = np.asarray(A, np.float64)
    np.testing.assert_allclose(np.asarray(ops.mv(v)),
                               np.einsum("bmn,bn->bm", Ad, v),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(ops.mtv(y)),
                               np.einsum("bmn,bm->bn", Ad, y),
                               rtol=2e-5, atol=2e-5)
    gram_ref = np.einsum("bmn,bn,bkn->bmk", Ad, np.asarray(w, np.float64),
                         Ad)
    np.testing.assert_allclose(np.asarray(ops.gram(w)), gram_ref,
                               rtol=1e-4, atol=1e-4)
    # take() slices lanes consistently
    idx = jnp.asarray([2, 0])
    sub = ops.take(idx)
    np.testing.assert_allclose(np.asarray(sub.mv(v[idx])),
                               np.asarray(ops.mv(v))[[2, 0]],
                               rtol=1e-6, atol=1e-6)


def test_structured_large_m_matches_f64_oracle(deep_lps):
    """The A-free core (solve_box_lp_ops + make_dc_linops) must pass the
    same deep-contingency oracle gate as the dense path — this is the
    production case300 branch of dcopf._solve_batch."""
    c, A, b, l, u, refs, ng, nd, base = deep_lps
    case = cases.case300s()
    sys_ = build_system(case)
    gen_col, br_up = _state_scalings(case, sys_, A.shape[0])
    ops = make_dc_linops(sys_, gen_col, br_up)
    sol = lp_ipm_batched.solve_box_lp_ops(c, b, l, u, ops, IPMConfig())
    _check(sol, refs, ng, nd, base)


def test_sharded_step_m792_8device_mesh():
    """The TRUE case300s shape (m=792) under a multi-device mesh: the
    full screened NSQ batch step — tier-1 certificates, island-PF tier,
    block-Schur XLA IPM with the rescue ladder, psum moment reduction —
    jitted over the 8-device scenario mesh and EXECUTED (the dryrun
    covers m=384 and the unsharded suite covers m=792, but no sharded
    m=792 execution existed anywhere). Moments must be finite, non-negative and
    carry the full sample count.

    Reference analog: the parfor scenario loop at nsqMain.m:257-263 run
    on the largest case class (README.md:47-49)."""
    import jax
    from powersystemsreliabilityassessment.parallel import mesh as meshlib
    from powersystemsreliabilityassessment.studies.hl2_nsq import (
        make_nsq_batch_step)

    case = cases.case300s()
    sys_ = build_system(case)
    mesh = meshlib.scenario_mesh()
    assert mesh.devices.size == 8
    step = make_nsq_batch_step(sys_, mesh, 128, CompatFlags(), IPMConfig(),
                               max_lp=16, nodal_mode="proportional")
    out = step(jax.random.key(0))
    jax.block_until_ready(out)
    m = out[0]
    assert float(m.n) == 8 * 128
    assert np.isfinite(float(m.sum_dns)) and float(m.sum_dns) >= 0.0
    assert np.isfinite(float(m.sum_dns_sq))
    assert int(out[1]) == 0  # no LP-buffer overflow at this batch size
