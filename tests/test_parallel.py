"""Mesh/collective layer on the 8-device virtual CPU mesh, plus the
end-to-end NSQ/SEQ studies at smoke scale."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P
from jax import shard_map

from powersystemsreliabilityassessment.core import cases
from powersystemsreliabilityassessment.parallel import accumulators, mesh as meshlib
from powersystemsreliabilityassessment.runtime.checkpoint import Checkpointer
from powersystemsreliabilityassessment.studies.hl2_nsq import run_nsq_study
from powersystemsreliabilityassessment.studies.hl2_seq import run_seq_study
from powersystemsreliabilityassessment.utils.config import MCSConfig


def test_virtual_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_psum_moments_equals_local_sum():
    mesh = meshlib.scenario_mesh()
    n_dev = mesh.devices.size
    rng = np.random.default_rng(0)
    dns = rng.uniform(0, 10, (n_dev * 4,)).astype(np.float32)
    nodal = rng.uniform(0, 1, (n_dev * 4, 24)).astype(np.float32)
    fail = dns > 5
    comp = rng.uniform(size=(n_dev * 4, 71)) < 0.3

    def f(d, no, fl, cm):
        return accumulators.psum_moments(
            accumulators.batch_moments(d, no, fl, cm))

    out = jax.jit(shard_map(
        f, mesh=mesh, in_specs=(P("scenarios"),) * 4,
        out_specs=accumulators.MOMENTS_OUT_SPECS, check_vma=False,
    ))(dns, nodal, fail, comp)

    ref = accumulators.batch_moments(jnp.asarray(dns), jnp.asarray(nodal),
                                     jnp.asarray(fail), jnp.asarray(comp))
    assert float(out.n) == dns.shape[0]
    assert float(out.sum_dns) == pytest.approx(float(ref.sum_dns), rel=1e-5)
    np.testing.assert_allclose(np.asarray(out.sum_nodal),
                               np.asarray(ref.sum_nodal), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(out.sum_comp_fail),
                               np.asarray(ref.sum_comp_fail), rtol=1e-5)


def test_running_stats_indices():
    s = accumulators.RunningStats()
    m = accumulators.BatchMoments(
        n=jnp.float32(4), sum_dns=jnp.float32(20.0),
        sum_dns_sq=jnp.float32(300.0), sum_flag=jnp.float32(2.0),
        sum_nodal=jnp.ones(3), sum_comp_fail=jnp.ones(5),
        sum_flag_raw=jnp.float32(2.0))
    s.update(m)
    assert s.edns == 5.0
    assert s.plc == 0.5
    assert s.lole(8760) == 0.5 * 8760
    # beta = sqrt(300 - 4*25) / (4*5)
    assert s.beta == pytest.approx(np.sqrt(200.0) / 20.0)


def test_component_importance_uses_raw_count_under_cv():
    # Control-variate mode: sum_flag holds RESIDUALS (flag - copper
    # indicator), whose total is ~0 — the conditional probability
    # P(comp down | failure) must divide the comp⊗failure numerator by
    # the raw failure count, not the residual sum.
    s = accumulators.RunningStats(mu_dns=5.0, mu_flag=0.25)
    s.update(accumulators.BatchMoments(
        n=jnp.float32(8), sum_dns=jnp.float32(0.0),
        sum_dns_sq=jnp.float32(0.0),
        sum_flag=jnp.float32(0.0),          # residuals cancelled
        sum_nodal=jnp.zeros(3),
        sum_comp_fail=jnp.asarray([1.0, 2.0, 0.0, 4.0, 4.0]),
        sum_flag_raw=jnp.float32(4.0)))     # 4 actual failure states
    np.testing.assert_allclose(s.component_importance(),
                               [0.25, 0.5, 0.0, 1.0, 1.0])
    # PLC still reflects the CV-adjusted estimator (mu offset).
    assert s.plc == pytest.approx(0.25)
    # Legacy checkpoints (written before sum_flag_raw existed) predate
    # CV mode: the fallback divides by sum_flag.
    legacy = accumulators.RunningStats(
        n=4.0, sum_flag=2.0, sum_comp_fail=np.asarray([1.0, 2.0]))
    np.testing.assert_allclose(legacy.component_importance(), [0.5, 1.0])


def test_running_stats_from_state_json_lists():
    # JSON checkpoints hold the array fields as lists; a restored run
    # that converges before folding another batch must still be able to
    # compute its index properties.
    r = accumulators.RunningStats.from_state({
        "n": 4.0, "sum_dns": 0.0, "sum_dns_sq": 0.0, "sum_flag": 2.0,
        "sum_nodal": [1.0, 2.0], "sum_comp_fail": [1.0, 2.0]})
    np.testing.assert_allclose(r.nodal_eens(8760), [2190.0, 4380.0])
    np.testing.assert_allclose(r.component_importance(), [0.5, 1.0])


class TestStudiesSmoke:
    def test_nsq_deterministic_and_sane(self, tmp_path):
        cfg = MCSConfig(batch_size=128, max_samples=256, seed=9)
        r1 = run_nsq_study(cases.rts24(), cfg, log_every=0)
        r2 = run_nsq_study(cases.rts24(), cfg, log_every=0)
        assert r1.edns_mw == r2.edns_mw  # keyed PRNG determinism
        assert r1.samples == 256
        assert 0 <= r1.plc <= 1
        assert r1.edns_mw >= 0
        assert len(r1.comp_importance) in (0, 71)

    def test_nsq_checkpoint_roundtrip(self, tmp_path):
        # Non-trivial RunningStats state must survive a save/restore cycle
        # exactly (including the nodal / component-importance arrays).
        ck = Checkpointer(str(tmp_path / "nsq.ckpt"))
        s0 = accumulators.RunningStats()
        s0.update(accumulators.BatchMoments(
            n=jnp.float32(4), sum_dns=jnp.float32(20.0),
            sum_dns_sq=jnp.float32(300.0), sum_flag=jnp.float32(2.0),
            sum_nodal=jnp.arange(3.0), sum_comp_fail=jnp.arange(5.0),
            sum_flag_raw=jnp.float32(2.0)))
        ck.save({"stats": s0.state(),
                 "histories": {"beta": [0.5], "edns": [5.0],
                               "lole": [], "plc": []},
                 "batch_idx": 7})
        restored = ck.restore()
        assert restored["batch_idx"] == 7
        assert restored["histories"]["beta"] == [0.5]
        s = accumulators.RunningStats.from_state(restored["stats"])
        assert s.n == s0.n and s.edns == s0.edns and s.beta == s0.beta
        np.testing.assert_array_equal(np.asarray(s.sum_nodal),
                                      np.asarray(s0.sum_nodal))
        np.testing.assert_array_equal(np.asarray(s.sum_comp_fail),
                                      np.asarray(s0.sum_comp_fail))

    def test_seq_smoke(self):
        cfg = MCSConfig(max_years=16, cov_threshold=0.0, seed=2)
        r = run_seq_study(cases.rts24(), cfg, years_per_device=2,
                          max_lp=96, hours=336, log_every=0)
        assert r.years == 16
        assert r.eens_mwh_yr >= 0
        assert r.lolf_occ_yr <= r.lole_hr_yr or r.lole_hr_yr == 0


def test_seq_with_maintenance_smoke():
    from powersystemsreliabilityassessment.studies.hl2_seq import (
        run_seq_study)
    cfg = MCSConfig(max_years=8, cov_threshold=0.0, seed=4)
    r = run_seq_study(cases.rts24(), cfg, years_per_device=1, max_lp=96,
                      hours=336, scheduled_maintenance=True, log_every=0)
    assert r.years == 8
    assert r.eens_mwh_yr >= 0


def test_hl1_rts24_and_scaleup_smoke():
    from powersystemsreliabilityassessment.studies import hl1_rts24
    gens = hl1_rts24.rts24_fleet()
    assert len(gens) == 32  # sync condenser excluded
    load = hl1_rts24.rts24_load(1000)
    from powersystemsreliabilityassessment.studies import hl1_comparison
    ana = hl1_comparison.run_analytical(gens, load, step=5.0)
    assert ana.lole_hours_yr >= 0

    from powersystemsreliabilityassessment.studies import scaleup
    out = scaleup.run(case_name="rts24", samples=256, batch_size=128,
                      antithetic=True)
    assert out["samples"] >= 256


def test_seq_flat_block_equals_per_year():
    # The flat [years*hours] evaluation must give the same annual indices
    # as evaluating each year alone (same per-year keys).
    import jax as _jax
    import jax.numpy as _jnp
    from powersystemsreliabilityassessment.core import load_profile
    from powersystemsreliabilityassessment.core.system import build_system
    from powersystemsreliabilityassessment.models import twostate
    from powersystemsreliabilityassessment.sampling import chronological
    from powersystemsreliabilityassessment.studies.hl2_seq import (
        _years_eval)
    from powersystemsreliabilityassessment.utils.config import (
        CompatFlags, IPMConfig)
    case = cases.rts24()
    sys_ = build_system(case, CompatFlags())
    hours = 336
    fac = _jnp.asarray(load_profile.load_factors(hours), _jnp.float32)
    mt = twostate.mean_times(case)
    nd = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    keys = _jax.random.split(_jax.random.key(17), 3)
    flat = _years_eval(sys_, CompatFlags(), IPMConfig(), fac, hours, nd,
                       3 * 96, None, "lp", keys)
    for y in range(3):
        one = _years_eval(sys_, CompatFlags(), IPMConfig(), fac, hours,
                          nd, 96, None, "lp", keys[y:y + 1])
        np.testing.assert_allclose(float(flat[0][y]), float(one[0][0]),
                                   atol=0.02)           # annual ENS (MWh)
        assert float(flat[3][y]) == float(one[3][0])    # DLC hours
        assert float(flat[2][y]) == float(one[2][0])    # NLC events


def test_seq_adaptive_lp_buffer():
    from powersystemsreliabilityassessment.studies.hl2_seq import (
        run_seq_study)
    # absurdly small initial buffer: the study must grow it and redo
    # batches rather than fall back to bounds.
    cfg = MCSConfig(max_years=8, cov_threshold=0.0, seed=6)
    r = run_seq_study(cases.rts24(), cfg, years_per_device=1, max_lp=8,
                      hours=336, log_every=0)
    assert r.years == 8
    assert r.overflow_hours == 0


def test_checkpoint_resume_equals_uninterrupted(tmp_path):
    from powersystemsreliabilityassessment.runtime.checkpoint import (
        Checkpointer)

    cfg_full = MCSConfig(batch_size=128, max_samples=512, seed=13)
    full = run_nsq_study(cases.rts24(), cfg_full, log_every=0)

    ck = Checkpointer(str(tmp_path / "resume.ckpt"))
    # Reproduce the study's own first two batches with its exact step +
    # key schedule, checkpoint that frontier, and verify resuming from it
    # reproduces the uninterrupted run's results.
    stats = accumulators.RunningStats()
    import jax as _jax
    from powersystemsreliabilityassessment.core.system import build_system
    from powersystemsreliabilityassessment.studies.hl2_nsq import (
        make_nsq_batch_step)
    from powersystemsreliabilityassessment.utils.config import (
        CompatFlags, IPMConfig)
    sys_ = build_system(cases.rts24(), CompatFlags())
    mesh = meshlib.scenario_mesh()
    bpd = 128 // mesh.devices.size
    step = make_nsq_batch_step(sys_, mesh, bpd, CompatFlags(), IPMConfig())
    root = _jax.random.key(13)
    for b in range(2):
        m, _, _ = step(_jax.random.fold_in(root, b))
        stats.update(m)
    ck.save({"stats": stats.state(), "histories": {
        "beta": [], "edns": [], "lole": [], "plc": []},
        "batch_idx": 2})
    resumed = run_nsq_study(cases.rts24(),
                            MCSConfig(batch_size=128, max_samples=512,
                                      seed=13),
                            checkpointer=ck, log_every=0)
    assert resumed.samples == full.samples
    assert resumed.edns_mw == pytest.approx(full.edns_mw, rel=1e-6)
    assert resumed.plc == pytest.approx(full.plc, rel=1e-9)


def test_seq_checkpoint_resume(tmp_path):
    """Interrupted SEQ run + resume == uninterrupted run (bit-identical
    EENS), because batch keys are fold_in(root, batch_idx) and the
    checkpoint records the consumed-batch frontier."""
    from powersystemsreliabilityassessment.runtime.checkpoint import (
        Checkpointer)
    from powersystemsreliabilityassessment.studies.hl2_seq import (
        run_seq_study)

    full = run_seq_study(cases.rts24(),
                         MCSConfig(max_years=16, cov_threshold=0.0, seed=21),
                         years_per_device=1, max_lp=64, hours=336,
                         log_every=0)

    ck = Checkpointer(str(tmp_path / "seq.ckpt"))
    # First half: one 8-year batch, checkpointed every batch.
    run_seq_study(cases.rts24(),
                  MCSConfig(max_years=8, cov_threshold=0.0, seed=21),
                  years_per_device=1, max_lp=64, hours=336,
                  checkpointer=ck, checkpoint_every=1, log_every=0)
    # Resume to the full horizon.
    resumed = run_seq_study(cases.rts24(),
                            MCSConfig(max_years=16, cov_threshold=0.0,
                                      seed=21),
                            years_per_device=1, max_lp=64, hours=336,
                            checkpointer=ck, checkpoint_every=1, log_every=0)
    assert resumed.years == full.years == 16
    assert resumed.eens_mwh_yr == pytest.approx(full.eens_mwh_yr, rel=1e-9)
    assert resumed.lole_hr_yr == pytest.approx(full.lole_hr_yr, rel=1e-9)
    np.testing.assert_allclose(resumed.nodal_eens_mwh_yr,
                               full.nodal_eens_mwh_yr, rtol=1e-9)


def test_nsq_adaptive_lp_buffer_redo_exact():
    from powersystemsreliabilityassessment.studies.hl2_nsq import (
        run_nsq_study)
    # Importance boost makes multi-outage (uncertified) states common, so
    # an absurdly small initial LP buffer MUST overflow; the study grows
    # it and redoes the batch with the same keys. Property: the final
    # indices are invariant to the initial buffer size, and no overflow
    # is ever *recorded* (recorded overflow = buffer already at batch
    # size, i.e. genuine saturation).
    cfg = MCSConfig(batch_size=128, max_samples=256, seed=21,
                    is_boost=4.0)
    small = run_nsq_study(cases.rts24(), cfg, log_every=0, max_lp=2)
    big = run_nsq_study(cases.rts24(), cfg, log_every=0)
    assert small.overflow_states == 0
    assert big.overflow_states == 0
    assert small.samples == big.samples
    assert small.edns_mw == pytest.approx(big.edns_mw, rel=1e-5)
    assert small.lole_hr_yr == pytest.approx(big.lole_hr_yr, rel=1e-5)
    np.testing.assert_allclose(small.nodal_eens_mwh_yr,
                               big.nodal_eens_mwh_yr, rtol=1e-4)


def test_default_max_lp_mode_aware():
    from powersystemsreliabilityassessment.studies.hl2_nsq import (
        default_max_lp)
    # "lp" mode sends every deficit state to the LP (~10% of peak
    # states); "proportional" only certificate failures (~0.044% since
    # the post-outage repair extension) — its buffer must be
    # correspondingly smaller (buffer lanes above the need are pure
    # IPM overhead).
    assert default_max_lp(4096, "lp") == 1024
    assert default_max_lp(4096, "proportional") == 64
    assert default_max_lp(4096, "proportional", is_boost=4.0) == 2048
    # Gens-only boost leaves branch (certificate-miss) rates at plain-MC
    # levels -> the unboosted default applies in proportional mode; "lp"
    # mode routes every DEFICIT state to the LP, and gens boost inflates
    # exactly those (measured ~9% -> ~44% at boost 2.5 on RTS-24).
    assert default_max_lp(4096, "proportional", is_boost=4.0,
                          is_boost_scope="gens") == 64
    assert default_max_lp(4096, "lp", is_boost=4.0,
                          is_boost_scope="gens") == 2048
    assert default_max_lp(8, "proportional") == 16   # floor


def test_default_woodbury_k_auto_rule():
    from powersystemsreliabilityassessment.core.system import build_system
    from powersystemsreliabilityassessment.studies.hl2_nsq import (
        default_woodbury_k)
    sys24 = build_system(cases.rts24())
    # RTS-24 plain MC: sum of branch unavailabilities ~0.015 ->
    # P(>=3 branch outages) ~6e-7 -> rank 2 (extra rank-4 selector
    # matmuls are pure memory traffic there).
    assert default_woodbury_k(sys24) == 2
    # All-component boost drives branch rates up ~boost x -> rank 4.
    assert default_woodbury_k(sys24, is_boost=42.0,
                              is_boost_scope="all") == 4
    # Gens-only boost leaves branch rates at the true measure -> rank 2.
    assert default_woodbury_k(sys24, is_boost=42.0,
                              is_boost_scope="gens") == 2
    # case300s: ~3% of plain-MC samples have >= 3 branch outages
    # (results/case300_cert_breakdown.json histogram) -> rank 4.
    sys300 = build_system(cases.case300s())
    assert default_woodbury_k(sys300) == 4


def test_nsq_gens_only_boost_agrees_with_plain():
    # The gens-only scope must estimate the SAME indices (unbiased IS);
    # smoke-scale statistical agreement + finite weights.
    plain = run_nsq_study(cases.rts24(),
                          MCSConfig(batch_size=1024, max_samples=4096,
                                    seed=9), log_every=0)
    isg = run_nsq_study(cases.rts24(),
                        MCSConfig(batch_size=1024, max_samples=4096,
                                  seed=9, is_boost=2.5,
                                  is_boost_scope="gens"), log_every=0)
    assert isg.edns_mw == pytest.approx(plain.edns_mw, rel=0.35)
    assert np.isfinite(isg.beta) and isg.overflow_states == 0


def test_nsq_branches_boost_agrees_with_plain():
    # Branch-only scope (the transmission/islanding-risk lever for
    # case300-class systems) must also be unbiased IS: statistical
    # agreement with plain MC at smoke scale, finite weights.
    plain = run_nsq_study(cases.rts24(),
                          MCSConfig(batch_size=1024, max_samples=4096,
                                    seed=9), log_every=0)
    isb = run_nsq_study(cases.rts24(),
                        MCSConfig(batch_size=1024, max_samples=4096,
                                  seed=9, is_boost=3.0,
                                  is_boost_scope="branches"), log_every=0)
    assert isb.edns_mw == pytest.approx(plain.edns_mw, rel=0.5)
    assert np.isfinite(isb.beta) and isb.overflow_states == 0


def test_nsq_mixture_step_agrees_with_plain():
    # Defensive-mixture area-gen IS (sampling.state.sample_states_mixture
    # wired via make_nsq_batch_step(mix=...)): unbiased by construction,
    # so the mesh-sharded step's weighted EDNS must agree with plain MC
    # within MC noise on RTS-96 (3 areas), and weights are bounded by
    # 1/alpha0.
    from powersystemsreliabilityassessment.core import cases
    from powersystemsreliabilityassessment.core.system import (
        build_system)
    from powersystemsreliabilityassessment.parallel import (
        mesh as meshlib)
    from powersystemsreliabilityassessment.studies.hl2_nsq import (
        gen_area_masks, make_nsq_batch_step)
    from powersystemsreliabilityassessment.utils.config import (
        CompatFlags, IPMConfig)

    case = cases.rts96()
    sysm = build_system(case, CompatFlags())
    masks = gen_area_masks(case)
    assert masks is not None and masks.shape[0] == 3
    mesh = meshlib.scenario_mesh()
    kw = dict(nodal_mode="proportional")
    plain = make_nsq_batch_step(sysm, mesh, 512, CompatFlags(),
                                IPMConfig(), **kw)
    mix = make_nsq_batch_step(sysm, mesh, 512, CompatFlags(), IPMConfig(),
                              mix=(masks, 2.0, 0.5), **kw)
    outs = {}
    for name, step in (("plain", plain), ("mix", mix)):
        tot = n = 0.0
        for i in range(3):
            out = step(jax.random.fold_in(jax.random.key(5), i))
            m, n_over = out[0], out[1]
            assert int(n_over) == 0
            tot += float(m.sum_dns)
            n += float(m.n)
        outs[name] = tot / n
    assert np.isfinite(outs["mix"])
    # loose agreement: 12k samples of a ~3 MW estimate
    assert outs["mix"] == pytest.approx(outs["plain"], rel=0.6, abs=2.0)


def test_seq_transient_redo_and_promotion(capsys):
    # The r5 chronological buffer policy: an overflowed batch redoes
    # through a TRANSIENT big-buffer step; 3 consecutive overflow redos
    # promote the size to the base step permanently. With an absurdly
    # small base every batch overflows, so the promotion must fire and
    # the result must still be exact (overflow_hours 0, grow-and-redo
    # invariance vs a comfortably-buffered run).
    from powersystemsreliabilityassessment.studies.hl2_seq import (
        run_seq_study)
    # 8-device mesh -> 8 years/batch; 40 years = 5 batches, enough for
    # the 3-consecutive-redo promotion to fire. load_scale 1.3 makes
    # most hours deficit hours ("lp" nodal mode routes them all to the
    # LP), so a 4-lane base overflows every batch.
    cfg = MCSConfig(max_years=40, cov_threshold=0.0, seed=6)
    small = run_seq_study(cases.rts24(), cfg, years_per_device=1,
                          max_lp=4, hours=336, log_every=0,
                          load_scale=1.3)
    logs = capsys.readouterr().out
    assert "transient" in logs            # redo path exercised
    assert "promoting" in logs            # promotion fired
    assert small.overflow_hours == 0
    big = run_seq_study(cases.rts24(), cfg, years_per_device=1,
                        max_lp=336, hours=336, log_every=0,
                        load_scale=1.3)
    assert small.eens_mwh_yr == pytest.approx(big.eens_mwh_yr, rel=1e-5)
    assert small.lole_hr_yr == pytest.approx(big.lole_hr_yr, rel=1e-6)
