"""Multilevel-splitting SEQ study: exactness of the estimator plumbing.

The key invariant: the split estimator is the PLAIN estimator whenever the
tail carries no fresh clones — either because no year reaches the level
(level -> -inf) or because K=1 (the only tail sample is the parent's own
continuation). Running both configurations on the same seed must produce
IDENTICAL indices; this exercises the pre/tail decomposition of every
index including the NLC boundary-rise bookkeeping.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from powersystemsreliabilityassessment.core import cases
from powersystemsreliabilityassessment.sampling import chronological
from powersystemsreliabilityassessment.studies.hl2_seq_split import (
    SplitConfig, run_seq_split_study)
from powersystemsreliabilityassessment.utils.config import MCSConfig


def test_from_state_up_matches_plain():
    # Starting all-UP with the same key reproduces sample_timeline's
    # continuous (quantize=False) realization exactly.
    case = cases.rts24()
    from powersystemsreliabilityassessment.models import twostate
    mt = twostate.mean_times(case)
    mttf = jnp.asarray(mt[:, 0], jnp.float32)
    mttr = jnp.asarray(mt[:, 1], jnp.float32)
    k = jax.random.key(11)
    nd = chronological.default_num_draws(mt[:, 0], mt[:, 1], 336)
    a = chronological.sample_timeline(k, mttf, mttr, 336, nd,
                                      quantize=False)
    b = chronological.sample_timeline_from_state(
        k, jnp.zeros(case.n_comp, bool), mttf, mttr, 336, nd)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_from_state_down_starts_down():
    case = cases.rts24()
    from powersystemsreliabilityassessment.models import twostate
    mt = twostate.mean_times(case)
    down0 = jnp.ones(case.n_comp, bool)
    nd = chronological.default_num_draws(mt[:, 0], mt[:, 1], 48)
    tl = chronological.sample_timeline_from_state(
        jax.random.key(3), down0, jnp.asarray(mt[:, 0], jnp.float32),
        jnp.asarray(mt[:, 1], jnp.float32), 48, nd)
    # hour 0 must be DOWN for every component
    assert bool(jnp.all(tl[:, 0]))


def test_split_estimator_reduces_to_plain():
    case = cases.rts24()
    cfg = MCSConfig(max_years=16, cov_threshold=0.0, seed=2)
    kw = dict(years_per_device=2, max_lp=64, hours=504, log_every=0)
    # never reaches the level -> plain path
    r_never = run_seq_split_study(
        case, cfg, SplitConfig(level_mw=-1e9, k_clones=3, max_split=2),
        **kw)
    # always split at T=0, but the only tail sample is the parent's own
    # continuation -> must reconstruct the plain estimate exactly
    r_k1 = run_seq_split_study(
        case, cfg, SplitConfig(level_mw=1e9, k_clones=1, max_split=2),
        **kw)
    assert r_k1.eens_mwh_yr == pytest.approx(r_never.eens_mwh_yr,
                                             rel=1e-6)
    assert r_k1.lole_hr_yr == pytest.approx(r_never.lole_hr_yr, rel=1e-9)
    assert r_k1.lolf_occ_yr == pytest.approx(r_never.lolf_occ_yr,
                                             rel=1e-9)
    np.testing.assert_allclose(r_k1.nodal_eens_mwh_yr,
                               r_never.nodal_eens_mwh_yr, rtol=1e-5)
    np.testing.assert_allclose(r_k1.comp_importance,
                               r_never.comp_importance, rtol=1e-5)


def test_shift_table_never_clamps():
    # Regression: the clone load-factor table must be padded so that
    # dynamic_slice(t, H) is in-bounds for EVERY split hour t <= H.
    # A table padded only to the next 128 multiple silently clamps all
    # t > pad onto t = pad (dynamic_slice clamps the start), which fed
    # clones the January load profile regardless of season and biased
    # the split EENS low by ~2x.
    from powersystemsreliabilityassessment.studies.hl2_seq_split import (
        _pad_shift_table)
    H = 8736
    fac = np.arange(H, dtype=np.float32)  # identity -> slice start visible
    tab = jnp.asarray(_pad_shift_table(fac))
    assert tab.shape[0] >= 2 * H
    assert tab.shape[0] % 128 == 0
    for t in (0, 96, 97, 5000, H - 1, H):
        got = np.asarray(jax.lax.dynamic_slice(tab, (t,), (H,)))
        want = np.concatenate([fac[t:], np.zeros(t, np.float32)])
        np.testing.assert_array_equal(got, want)


def test_split_runs_and_is_sane():
    r = run_seq_split_study(
        cases.rts24(), MCSConfig(max_years=16, cov_threshold=0.0, seed=2),
        SplitConfig(level_mw=400.0, k_clones=3, max_split=4),
        years_per_device=2, max_lp=64, hours=504, log_every=0)
    assert r.years == 16
    assert r.eens_mwh_yr >= 0
    assert r.lolf_occ_yr <= r.lole_hr_yr or r.lole_hr_yr == 0


def test_split_auto_level_calibration():
    r = run_seq_split_study(
        cases.rts24(), MCSConfig(max_years=8, cov_threshold=0.0, seed=4),
        SplitConfig(level_mw=None, k_clones=2, max_split=2,
                    entry_target=0.25, pilot_years=128),
        years_per_device=1, max_lp=64, hours=504, log_every=0)
    assert r.years == 8
    assert r.eens_mwh_yr >= 0
    # with a 25% entry target, some of the 8 parent years should enter
    assert r.split_entered >= 1


def test_split_checkpoint_resume_equals_uninterrupted(tmp_path):
    from powersystemsreliabilityassessment.runtime.checkpoint import (
        Checkpointer)
    cfg = MCSConfig(max_years=24, cov_threshold=0.0, seed=9)
    kw = dict(years_per_device=1, max_lp=64, hours=504, log_every=0)
    sc = SplitConfig(level_mw=600.0, k_clones=2, max_split=2)
    full = run_seq_split_study(cases.rts24(), cfg, sc, **kw)
    # interrupted run (3 batches of 8 years): checkpoint every batch,
    # stop after the first
    ck = Checkpointer(str(tmp_path / "split.ckpt"))
    run_seq_split_study(
        cases.rts24(), MCSConfig(max_years=8, cov_threshold=0.0, seed=9),
        sc, checkpointer=ck, checkpoint_every=1, **kw)
    resumed = run_seq_split_study(
        cases.rts24(), cfg, sc, checkpointer=ck, checkpoint_every=1, **kw)
    assert resumed.years == full.years
    assert resumed.eens_mwh_yr == pytest.approx(full.eens_mwh_yr,
                                                rel=1e-6)
    assert resumed.lolf_occ_yr == pytest.approx(full.lolf_occ_yr,
                                                rel=1e-9)
    np.testing.assert_allclose(resumed.nodal_eens_mwh_yr,
                               full.nodal_eens_mwh_yr, rtol=1e-5)


def test_antithetic_from_state_distribution():
    # The antithetic draw must be exactly distributed: steady-state
    # down-fraction of a component over many independent pairs matches
    # the plain draw's within MC tolerance.
    case = cases.rts24()
    from powersystemsreliabilityassessment.models import twostate
    mt = twostate.mean_times(case)
    mttf = jnp.asarray(mt[:, 0], jnp.float32)
    mttr = jnp.asarray(mt[:, 1], jnp.float32)
    nd = chronological.default_num_draws(mt[:, 0], mt[:, 1], 336)
    down0 = jnp.zeros(case.n_comp, bool)
    keys = jax.random.split(jax.random.key(5), 64)
    frac = []
    for anti in (False, True):
        tl = jax.vmap(lambda k: chronological.sample_timeline_from_state(
            k, down0, mttf, mttr, 336, nd, antithetic=anti))(keys)
        frac.append(float(jnp.mean(tl[:, :33].astype(jnp.float32))))
    # same marginal law -> same expected down fraction (MC noise only)
    assert abs(frac[0] - frac[1]) < 0.01


def test_split_k1_midyear_level_reduces_to_plain():
    # K=1 with a level that triggers MID-YEAR entry (T > 0): pre-segment
    # + the parent's own tail must reconstruct the plain full-year
    # estimate exactly — in particular the LOLF boundary rise at the
    # split hour must be anchored at T, not at absolute hour 0 (a
    # curtailment event straddling T would otherwise be double-counted).
    case = cases.rts24()
    cfg = MCSConfig(max_years=16, cov_threshold=0.0, seed=2)
    kw = dict(years_per_device=2, max_lp=64, hours=504, log_every=0)
    kw["load_scale"] = 1.2
    r_never = run_seq_split_study(
        case, cfg, SplitConfig(level_mw=-1e9, k_clones=3, max_split=2),
        **kw)
    # Level -100 MW sits INSIDE deep-deficit events (shed starts near
    # margin 0), so the split hour T lands mid-event: flag[T-1] and
    # flag[T] are both set for 5 of the 16 parents at this seed — the
    # straddle that the position-0 anchor double-counted (mutation-
    # verified: reverting start_idx=Tsel fails this test).
    r_k1 = run_seq_split_study(
        case, cfg, SplitConfig(level_mw=-100.0, k_clones=1, max_split=4),
        **kw)
    assert r_k1.split_entered > 0  # the level actually triggered
    assert r_k1.eens_mwh_yr == pytest.approx(r_never.eens_mwh_yr,
                                             rel=1e-6)
    assert r_k1.lole_hr_yr == pytest.approx(r_never.lole_hr_yr, rel=1e-9)
    assert r_k1.lolf_occ_yr == pytest.approx(r_never.lolf_occ_yr,
                                             rel=1e-9)
    np.testing.assert_allclose(r_k1.nodal_eens_mwh_yr,
                               r_never.nodal_eens_mwh_yr, rtol=1e-5)
