"""Enumeration hybrid (sampling/enumeration.py + hl2_nsq enum_order).

The exact part must reproduce a brute-force weighted evaluation, its
probability mass must match an independent Poisson-binomial DP, the
device step's tail mask must be exactly complementary to the enumerated
set, and the full study must wire the offsets through RunningStats and
checkpoints.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from powersystemsreliabilityassessment.core import cases
from powersystemsreliabilityassessment.core.system import build_system
from powersystemsreliabilityassessment.engines import dcopf
from powersystemsreliabilityassessment.sampling import enumeration
from powersystemsreliabilityassessment.sampling.state import sample_states
from powersystemsreliabilityassessment.studies.hl2_nsq import (
    make_nsq_batch_step, run_nsq_study)
from powersystemsreliabilityassessment.parallel import (
    accumulators, mesh as meshlib)
from powersystemsreliabilityassessment.utils.config import (
    CompatFlags, IPMConfig, MCSConfig)


COMPAT, IPM = CompatFlags(), IPMConfig()


def _sys():
    return build_system(cases.rts24(), COMPAT)


def _poisson_binomial_cdf(p, k):
    """P(#down <= k) by exact f64 DP — independent of the module."""
    pb = np.zeros(len(p) + 1, np.float64)
    pb[0] = 1.0
    for ui in p:
        pb[1:] = pb[1:] * (1 - ui) + pb[:-1] * ui
        pb[0] *= 1 - ui
    return float(np.sum(pb[:k + 1]))


def test_enumerated_mass_matches_poisson_binomial():
    sys_ = _sys()
    unavail = np.asarray(sys_.unavail, np.float64)
    always_up = np.asarray(sys_.always_up_nsq, bool)
    free = enumeration.free_components(unavail, always_up)
    # The sync condenser (comp index 14, mc_sampling.m:40-41) is pinned.
    assert 14 not in free
    p = unavail[free]
    logit = np.log(p) - np.log1p(-p)
    log_base = float(np.sum(np.log1p(-p)))
    mass = float(np.exp(log_base))
    n = 0
    for j, combos in enumeration._combo_chunks(len(free), 2, chunk=997):
        w = np.exp(enumeration.state_log_weights(combos, logit, log_base))
        mass += float(np.sum(w))
        n += combos.shape[0]
    assert n == len(free) + len(free) * (len(free) - 1) // 2
    assert mass == pytest.approx(_poisson_binomial_cdf(p, 2), rel=1e-12)


def test_exact_part_matches_bruteforce_order1():
    """enumerate_exact (chunked, padded) == direct weighted evaluation."""
    sys_ = _sys()
    ex = enumeration.enumerate_exact(sys_, COMPAT, IPM, "proportional",
                                     order=1, chunk=32)

    unavail = np.asarray(sys_.unavail, np.float64)
    free = enumeration.free_components(
        unavail, np.asarray(sys_.always_up_nsq, bool))
    n_comp = unavail.shape[0]
    # All-up + every single-outage state, evaluated in one batch.
    down = np.zeros((1 + len(free), n_comp), bool)
    down[1 + np.arange(len(free)), free] = True
    p = unavail[free]
    log_base = float(np.sum(np.log1p(-p)))
    w = np.concatenate([[1.0], p / (1 - p)]) * np.exp(log_base)
    load = jnp.broadcast_to(sys_.load_pd[None, :],
                            (down.shape[0], sys_.n_load))
    res, n_over = dcopf.evaluate_states_screened(
        sys_, jnp.asarray(down), load, 64, COMPAT, IPM, "proportional")
    assert int(n_over) == 0
    dns = np.asarray(res.dns_mw, np.float64)
    fail = np.asarray(res.failure, np.float64)

    assert ex.n_states == down.shape[0]
    assert ex.mass == pytest.approx(float(np.sum(w)), rel=1e-12)
    assert ex.edns_mw == pytest.approx(float(w @ dns), rel=1e-6, abs=1e-9)
    assert ex.pfail == pytest.approx(float(w @ fail), rel=1e-6, abs=1e-12)
    np.testing.assert_allclose(
        ex.nodal_mw, w @ np.asarray(res.nodal_mw, np.float64),
        rtol=1e-6, atol=1e-9)
    comp_fail = np.zeros(n_comp)
    comp_fail[free] = w[1:] * fail[1:]
    np.testing.assert_allclose(ex.comp_fail, comp_fail,
                               rtol=1e-6, atol=1e-12)
    # Exact EDNS part must be a nonneg underestimate of the full index.
    assert 0.0 <= ex.edns_mw
    assert ex.tail_mass == pytest.approx(1.0 - ex.mass, abs=1e-12)


def test_step_tail_mask_complementary():
    """plain-step moments == enum-step moments + host-masked low-order
    part: the mask is exactly 1(#down > k), nothing lost or doubled."""
    sys_ = _sys()
    mesh = meshlib.scenario_mesh()
    bpd = 16
    k_enum = 2
    common = dict(compat=COMPAT, ipm=IPM, max_lp=bpd, nodal_mode="lp")
    plain = make_nsq_batch_step(sys_, mesh, bpd, **common)
    enum_step = make_nsq_batch_step(sys_, mesh, bpd, enum_order=k_enum,
                                    **common)
    key = jax.random.key(5)
    mp, _, _ = plain(key)
    me, _, _ = enum_step(key)

    # Recompute the low-order complement on host from the same states.
    n_dev = mesh.devices.size
    dns_lo = flag_lo = 0.0
    dns_sq_delta = 0.0
    for dev in range(n_dev):
        # device d draws from fold_in(key, d) (mesh.device_keys)
        down = sample_states(jax.random.fold_in(key, dev), sys_.unavail,
                             sys_.always_up_nsq, bpd)
        load = jnp.broadcast_to(sys_.load_pd[None, :], (bpd, sys_.n_load))
        res, _ = dcopf.evaluate_states_screened(
            sys_, down, load, bpd, COMPAT, IPM, "lp")
        lo = np.asarray(jnp.sum(down, axis=1) <= k_enum)
        dns = np.asarray(res.dns_mw, np.float64)
        dns_lo += float(np.sum(dns * lo))
        flag_lo += float(np.sum(np.asarray(res.failure) * lo))
        dns_sq_delta += float(np.sum((dns * lo) ** 2))

    assert float(me.n) == float(mp.n)
    assert float(mp.sum_dns) - float(me.sum_dns) == pytest.approx(
        dns_lo, rel=1e-5, abs=1e-4)
    assert float(mp.sum_flag) - float(me.sum_flag) == pytest.approx(
        flag_lo, abs=1e-6)
    # Masked dns is dns*1(tail): squares differ by the low-order squares.
    assert float(mp.sum_dns_sq) - float(me.sum_dns_sq) == pytest.approx(
        dns_sq_delta, rel=1e-4, abs=1e-2)


def test_enum_study_end_to_end():
    cfg = MCSConfig(batch_size=128, max_samples=512, beta_limit=0.0,
                    seed=11)
    res = run_nsq_study(cases.rts24(), cfg, log_every=0, enum_order=2,
                        max_lp=32)
    assert res.enum_order == 2
    assert res.enum_states == 1 + 70 + 70 * 69 // 2
    assert 0.82 < res.enum_mass < 0.84          # P(#down<=2) = 0.8276
    # The exact k=2 part is deterministic: full EDNS ~14.7 minus the
    # measured tail term E[DNS*1(#down>2)] ~12.2 puts it at ~2.45 MW.
    assert res.enum_edns_exact_mw == pytest.approx(2.45, abs=0.35)
    assert res.edns_mw >= res.enum_edns_exact_mw
    assert np.isfinite(res.beta)
    # Offsets flow into nodal/importance outputs.
    assert res.nodal_eens_mwh_yr.sum() > 0
    assert res.comp_importance.max() <= 1.0 + 1e-9


def test_enum_study_checkpoint_resume(tmp_path):
    from powersystemsreliabilityassessment.runtime.checkpoint import (
        Checkpointer)
    cfg = MCSConfig(batch_size=128, max_samples=768, beta_limit=0.0,
                    seed=13)
    full = run_nsq_study(cases.rts24(), cfg, log_every=0, enum_order=2,
                         max_lp=32)

    ck = Checkpointer(str(tmp_path / "enum_ck"))
    half = MCSConfig(batch_size=128, max_samples=256, beta_limit=0.0,
                     seed=13)
    run_nsq_study(cases.rts24(), half, log_every=0, enum_order=2,
                  max_lp=32, checkpointer=ck, checkpoint_every=1)
    resumed = run_nsq_study(cases.rts24(), cfg, log_every=0, enum_order=2,
                            max_lp=32, checkpointer=ck,
                            checkpoint_every=1)
    assert resumed.samples == full.samples
    assert resumed.edns_mw == pytest.approx(full.edns_mw, rel=1e-9)
    assert resumed.enum_mass == pytest.approx(full.enum_mass, rel=1e-12)
    np.testing.assert_allclose(resumed.nodal_eens_mwh_yr,
                               full.nodal_eens_mwh_yr, rtol=1e-9)


def test_enum_cv_mutually_exclusive():
    with pytest.raises(ValueError):
        run_nsq_study(cases.rts24(), MCSConfig(batch_size=128,
                                               max_samples=128),
                      log_every=0, enum_order=2, control_variate=True)


def test_unrank_combinations_bijective_vs_itertools():
    # The colex unranking must cover EXACTLY the set of j-subsets (as
    # sorted tuples) that itertools.combinations yields — the hot-loop
    # replacement (293 s of host iterator time for C(71,5) -> <1 s)
    # must be a pure reordering, never a re-weighting.
    import itertools
    for n, j in [(7, 1), (9, 2), (12, 3), (10, 4), (11, 5)]:
        total = enumeration.count_states(n, j) - enumeration.count_states(
            n, j - 1)
        ranks = np.arange(total, dtype=np.int64)
        got = enumeration.unrank_combinations(ranks, j, n)
        assert got.shape == (total, j)
        # ascending indices within each row
        assert (np.diff(got, axis=1) > 0).all() if j > 1 else True
        got_set = {tuple(r) for r in got.tolist()}
        ref_set = set(itertools.combinations(range(n), j))
        assert got_set == ref_set


def test_unrank_combinations_large_rank_exact():
    # Exactness at case300 scale: C(888, 5) ~ 4.5e12 ranks must unrank
    # without int64 overflow or float rounding; spot-check that the
    # unranked subset's colex rank reconstructs the input rank.
    from math import comb
    n, j = 888, 5
    total = comb(n, j)
    ranks = np.asarray([0, 1, 12345678901, total - 2, total - 1], np.int64)
    got = enumeration.unrank_combinations(ranks, j, n)
    for r, row in zip(ranks.tolist(), got.tolist()):
        assert sorted(row) == row
        assert sum(comb(c, i + 1) for i, c in enumerate(row)) == r
