"""Stationary chronological sampling + copper-sheet control variate
(studies/hl2_seq.py sampling="stationary" / control_variate=True).

The reference's SEQ loop is plain MC from an all-up start
(seqMain.m:85-199); these paths are framework extensions, so the tests
pin their math from first principles: stationary marginals, the exact
f64 control-variate means against brute-force state enumeration, the
device copper values against a host recomputation, and the estimator's
unbiasedness + variance contraction.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from powersystemsreliabilityassessment.core import cases, load_profile
from powersystemsreliabilityassessment.core.system import build_system
from powersystemsreliabilityassessment.engines import copt
from powersystemsreliabilityassessment.models import twostate
from powersystemsreliabilityassessment.sampling import chronological
from powersystemsreliabilityassessment.studies import hl2_seq
from powersystemsreliabilityassessment.utils.config import (
    CompatFlags, IPMConfig, MCSConfig)


def test_stationary_marginals_match_unavailability():
    # With a stationary start, P[down at hour h] = U for EVERY h.
    mttf = jnp.asarray([400.0, 60.0, 1200.0], jnp.float32)
    mttr = jnp.asarray([100.0, 40.0, 50.0], jnp.float32)
    u = np.asarray(mttr / (mttf + mttr))
    hours, n = 72, 4000
    keys = jax.random.split(jax.random.key(11), n)
    down = jax.vmap(lambda k: chronological.sample_timeline_stationary(
        k, mttf, mttr, hours, 16))(keys)          # [n, 3, hours]
    frac = np.asarray(jnp.mean(down.astype(jnp.float32), axis=0))
    for h in (0, hours // 2, hours - 1):
        se = np.sqrt(u * (1 - u) / n)
        assert np.all(np.abs(frac[:, h] - u) < 5 * se), (h, frac[:, h], u)


def test_copper_cv_means_exact_vs_enumeration():
    caps = np.array([5.0, 10.0, 20.0])
    q = np.array([0.1, 0.25, 0.05])
    loads = np.array([3.7, 12.0, 28.2, 34.9, 1.0])
    thresh = 0.01
    mu_e, mu_l, eue_h, lolp_h = copt.copper_cv_means(caps, q, loads,
                                                     thresh_mw=thresh)
    # Brute force over the 8 outage states.
    e_ref = np.zeros_like(loads)
    l_ref = np.zeros_like(loads)
    for m in range(8):
        upmask = np.array([(m >> i) & 1 == 0 for i in range(3)])
        p = np.prod(np.where(upmask, 1 - q, q))
        cap = caps[upmask].sum()
        deficit = np.maximum(loads - cap, 0.0)
        e_ref += p * deficit
        l_ref += p * (deficit > thresh)
    np.testing.assert_allclose(eue_h, e_ref, atol=1e-12)
    np.testing.assert_allclose(lolp_h, l_ref, atol=1e-12)
    np.testing.assert_allclose(mu_e, e_ref.sum(), rtol=1e-13)
    np.testing.assert_allclose(mu_l, l_ref.sum(), rtol=1e-13)


def test_years_eval_copper_values_match_host_recompute():
    case = cases.rts24()
    compat, ipm = CompatFlags(), IPMConfig()
    sys = build_system(case, compat)
    hours = 48
    factors = load_profile.load_factors(hours, compat.weekday_mode)
    mt = twostate.mean_times(case)
    n_draws = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    gen_cap_mw = np.asarray(case.gen_pmax, np.float32)
    total = float(np.sum(np.asarray(case.bus_pd, np.float64)))
    loads_mw = (np.asarray(factors, np.float64) * total).astype(np.float32)
    keys = jax.random.split(jax.random.key(3), 2)

    outs = hl2_seq._years_eval(
        sys, compat, ipm, jnp.asarray(factors, jnp.float32), hours,
        n_draws, 64, None, "none", keys, stationary=True,
        cv_arrays=(jnp.asarray(loads_mw), jnp.asarray(gen_cap_mw)))
    c_ens, c_dlc = np.asarray(outs[10]), np.asarray(outs[11])

    # Same keys => same timelines; recompute copper deficits on host.
    down = jax.vmap(lambda k: chronological.sample_timeline_stationary(
        k, sys.mttf, sys.mttr, hours, n_draws))(keys)
    up = 1.0 - np.asarray(down)[:, :case.n_gen, :].astype(np.float32)
    cap = np.einsum("ygh,g->yh", up, gen_cap_mw)
    deficit = np.maximum(loads_mw[None, :] - cap, 0.0)
    np.testing.assert_allclose(c_ens, deficit.sum(axis=1), rtol=1e-6)
    np.testing.assert_array_equal(
        c_dlc, (deficit > compat.seq_curtail_threshold_mw).sum(axis=1))


def test_cv_estimator_unbiased_and_tighter():
    # Same seed => identical sample paths; the CV run differs only by the
    # per-year adjustment -C_i + mu_C. load_scale 1.3 on the January peak
    # week makes every year shed (peak 3705 MW > 3405 MW fleet), so the
    # annual distribution is not zero-inflated and 16 years suffice.
    case = cases.rts24()
    compat = CompatFlags()
    cfg = MCSConfig(max_years=12, cov_threshold=0.0, seed=5)
    kw = dict(years_per_device=2, max_lp=168, hours=168, log_every=0,
              load_scale=1.3)
    plain = hl2_seq.run_seq_study(case, cfg, sampling="stationary", **kw)
    cv = hl2_seq.run_seq_study(case, cfg, control_variate=True, **kw)
    assert plain.years == cv.years

    a_p = np.asarray(plain.annual_ens)
    a_c = np.asarray(cv.annual_ens)
    assert a_p.std() > 0  # the config sheds
    # Variance contraction: copper deficit explains most ENS variance.
    assert a_c.std() < 0.5 * a_p.std(), (a_c.std(), a_p.std())
    # Unbiasedness, anchored to the EXACT copper mean: E[ENS] >= mu_C
    # (the network can only add shed) and at RTS-24 the network's extra
    # shed is small, so the CV estimate must land just above mu_C.
    factors = (np.asarray(load_profile.load_factors(
        168, compat.weekday_mode), np.float64) * 1.3)
    loads = (factors * float(case.bus_pd.sum())).astype(np.float32)
    mu_e, _, _, _ = copt.copper_cv_means(
        np.asarray(case.gen_pmax, np.float64),
        twostate.unavailability(case)[:case.n_gen],
        loads.astype(np.float64),
        thresh_mw=compat.seq_curtail_threshold_mw)
    sig_c = a_c.std(ddof=1) / np.sqrt(len(a_c))
    assert mu_e - 5 * sig_c < cv.eens_mwh_yr < 1.25 * mu_e + 5 * sig_c, (
        cv.eens_mwh_yr, mu_e, sig_c)
    # LOLE adjustment is applied too and stays sane.
    assert cv.lole_hr_yr >= 0.0


def test_cv_rejects_maintenance():
    import pytest
    with pytest.raises(ValueError):
        hl2_seq.run_seq_study(
            cases.rts24(), MCSConfig(max_years=2, cov_threshold=0.0),
            control_variate=True, scheduled_maintenance=True,
            years_per_device=1, hours=48, log_every=0)


# ---- NSQ copper control variate (studies/hl2_nsq.py) --------------------

def _nsq_copper_mu():
    case = cases.rts24()
    compat = CompatFlags()
    total = np.float32(np.sum(np.asarray(case.bus_pd, np.float64)))
    mu_e, mu_l, _, _ = copt.copper_cv_means(
        np.asarray(case.gen_pmax, np.float64),
        twostate.unavailability(case)[:case.n_gen],
        np.asarray([total], np.float64),
        thresh_mw=compat.nsq_fail_flag_threshold_mw)
    return mu_e, mu_l


def test_nsq_cv_unbiased_and_tighter():
    from powersystemsreliabilityassessment.studies.hl2_nsq import (
        run_nsq_study)
    case = cases.rts24()
    cfg = MCSConfig(batch_size=256, max_samples=1024, beta_limit=0.0,
                    seed=7)
    plain = run_nsq_study(case, cfg, log_every=0)
    cv = run_nsq_study(case, cfg, log_every=0, control_variate=True)
    assert plain.samples == cv.samples == 1024
    mu_e, mu_l = _nsq_copper_mu()
    # beta tracks the CV estimator's CoV: must contract hard (copper
    # explains ~97% of DNS variance at RTS-24 peak load).
    assert cv.beta < 0.5 * plain.beta, (cv.beta, plain.beta)
    # Anchored unbiasedness: E[DNS] >= mu_C (network only adds shed) and
    # the network's extra shed at RTS-24 is ~2.5% (PARITY.md).
    sig = cv.beta * cv.edns_mw
    assert mu_e - 5 * sig < cv.edns_mw < 1.25 * mu_e + 5 * sig
    # PLC is adjusted too; its exact copper mean is the anchor.
    assert abs(cv.plc - mu_l) < 0.5 * mu_l + 0.02
    # Raw-value accumulators (nodal, weak points) are untouched.
    np.testing.assert_allclose(cv.nodal_eens_mwh_yr,
                               plain.nodal_eens_mwh_yr, rtol=1e-6)


def test_nsq_cv_composes_with_importance_sampling():
    from powersystemsreliabilityassessment.studies.hl2_nsq import (
        run_nsq_study)
    case = cases.rts24()
    cfg = MCSConfig(batch_size=256, max_samples=1024, beta_limit=0.0,
                    seed=11, is_boost=2.0)
    cv = run_nsq_study(case, cfg, log_every=0, control_variate=True)
    mu_e, _ = _nsq_copper_mu()
    sig = max(cv.beta, 0.01) * cv.edns_mw
    # E_q[w C] = mu_C exactly, so the IS+CV estimate stays anchored.
    assert mu_e - 6 * sig < cv.edns_mw < 1.3 * mu_e + 6 * sig, (
        cv.edns_mw, mu_e, sig)
