"""HL1 engines: copper-sheet MC vs. analytical COPT cross-validation —
the reference's de-facto integration test (SURVEY.md §4.1), formalized
with fixed PRNG keys and quantitative tolerances."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from powersystemsreliabilityassessment.engines import copper_sheet, copt
from powersystemsreliabilityassessment.sampling import chronological


# Demo fleet in the spirit of run_full_comparison.jl:6-16
CAPS = np.array([200, 200, 150, 150, 100, 100, 50, 50], dtype=np.float32)
MTTF = np.array([1000, 1100, 900, 950, 1200, 1150, 800, 850], np.float32)
MTTR = np.array([50, 60, 45, 55, 40, 50, 30, 35], np.float32)
FOR_ = MTTR / (MTTF + MTTR)


def load_curve(hours=8760):
    h = np.arange(hours)
    return (600 + 200 * np.sin(2 * np.pi * h / hours)
            + 50 * np.sin(2 * np.pi * h / 24)).astype(np.float32)


class TestCopperSheet:
    def test_annual_indices_exact(self):
        load = load_curve(100)
        curve = copper_sheet.LoadCurve.build(load)
        for cap in (500.0, 650.0, 900.0):
            lole, eue = copper_sheet.annual_indices_from_capacity(
                jnp.float32(cap), curve)
            deficit = np.maximum(load - cap, 0)
            assert float(lole) == (deficit > 0).sum()
            assert float(eue) == pytest.approx(deficit.sum(), rel=1e-5)

    def test_event_counting(self):
        # calnlc.m:22-34 incl. the starts-failed edge case
        flags = jnp.asarray([[0, 1, 1, 0, 1, 0, 0, 1],
                             [1, 1, 0, 0, 0, 0, 0, 0],
                             [0, 0, 0, 0, 0, 0, 0, 0]], bool)
        n = copper_sheet.count_curtailment_events(flags)
        assert np.asarray(n).tolist() == [3, 1, 0]

    def test_hourly_deficit(self):
        load = jnp.asarray([100.0, 200.0, 150.0])
        cap = jnp.asarray([[150.0, 150.0, 150.0]])
        lole, eens, d = copper_sheet.hourly_deficit(cap, load)
        assert float(lole[0]) == 1
        assert float(eens[0]) == 50.0


class TestCOPT:
    def test_two_unit_closed_form(self):
        # 2 x 16 MW units with q = 0.02: exact state probabilities
        probs = copt.build_copt(jnp.asarray([16.0, 16.0]),
                                jnp.asarray([0.02, 0.02]), 1.0, 33)
        p = np.asarray(probs)
        assert p[0] == pytest.approx(0.98 ** 2, rel=1e-5)
        assert p[16] == pytest.approx(2 * 0.98 * 0.02, rel=1e-5)
        assert p[32] == pytest.approx(0.02 ** 2, rel=1e-5)
        assert p.sum() == pytest.approx(1.0, rel=1e-5)

    def test_rounding_split(self):
        # 56 MW unit on a 20 MW grid: q split 0.2/0.8 between 40/60
        # (generating_adequacy_assessment.jl:91-104 logic)
        probs = copt.build_copt(jnp.asarray([56.0]), jnp.asarray([0.1]),
                                20.0, 5)
        p = np.asarray(probs)
        assert p[0] == pytest.approx(0.9, rel=1e-5)
        assert p[2] == pytest.approx(0.1 * (1 - 0.8), rel=1e-4)
        assert p[3] == pytest.approx(0.1 * 0.8, rel=1e-4)

    def test_fd_16mw_example(self):
        # The hand-checkable PPT example (generating_adequacy_frequency.jl
        # :204-228): 2 x 16 MW, lambda = 2/yr, mu = 98/yr.
        lam, mu = 2.0, 98.0
        q = lam / (lam + mu)
        cum_p, cum_f = copt.build_copt_fd(
            jnp.asarray([16.0, 16.0]), jnp.asarray([q, q]),
            jnp.asarray([lam, lam]), 1.0, 33)
        p = 1 - q
        # P(X >= 16) = 1 - p^2 ; F(X >= 16) = p^2 * 2 lambda (up-crossings)
        assert float(cum_p[16]) == pytest.approx(1 - p * p, rel=1e-5)
        assert float(cum_f[16]) == pytest.approx(p * p * 2 * lam, rel=1e-4)
        # risk at peak 20 MW, installed 32 -> reserve 12, first level >12=13
        lole, lolf, lold = copt.fd_risk(cum_p, cum_f, 1.0, 32.0, 20.0)
        assert float(lole) == pytest.approx((1 - p * p) * 8760, rel=1e-4)
        assert float(lolf) == pytest.approx(p * p * 2 * lam, rel=1e-4)
        assert float(lold) == pytest.approx(
            (1 - p * p) * 8760 / (p * p * 2 * lam), rel=1e-3)

    def test_analytical_vs_nsq_mc(self):
        # Cross-method agreement (PowerSystemAdequacy.jl compare_results):
        # analytical COPT vs non-sequential MC within MC noise.
        load = load_curve()
        curve = copper_sheet.LoadCurve.build(load)
        caps = jnp.asarray(CAPS)
        fors = jnp.asarray(FOR_)
        n = copt.grid_points_for(float(CAPS.sum()), 10.0)
        probs = copt.build_copt(caps, fors, 10.0, n)
        lole_a, eue_a = copt.lole_eue(probs, 10.0, float(CAPS.sum()),
                                      jnp.asarray(load))
        lole_mc, eue_mc, _ = copper_sheet.nsq_batch(
            jax.random.key(0), caps, fors, curve, 3000)
        assert float(lole_mc.mean()) == pytest.approx(float(lole_a),
                                                      rel=0.15)
        assert float(eue_mc.mean()) == pytest.approx(float(eue_a), rel=0.2)

    def test_analytical_vs_seq_mc(self):
        load = load_curve()
        caps = jnp.asarray(CAPS)
        n = copt.grid_points_for(float(CAPS.sum()), 10.0)
        probs = copt.build_copt(caps, jnp.asarray(FOR_), 10.0, n)
        lole_a, eue_a = copt.lole_eue(probs, 10.0, float(CAPS.sum()),
                                      jnp.asarray(load))
        k = chronological.default_num_draws(MTTF, MTTR, 8760)
        down = chronological.sample_timeline_batch(
            jax.random.key(1), jnp.asarray(MTTF), jnp.asarray(MTTR),
            8760, k, 200)
        cap_series = copper_sheet.capacity_series_from_down(down, caps)
        lole_y, eens_y, _ = copper_sheet.hourly_deficit(
            cap_series, jnp.asarray(load))
        assert float(lole_y.mean()) == pytest.approx(float(lole_a), rel=0.2)
        assert float(eens_y.mean()) == pytest.approx(float(eue_a), rel=0.25)

    def test_lfu_increases_risk(self):
        # Load-forecast uncertainty raises LOLE (convexity)
        load = load_curve()
        caps = jnp.asarray(CAPS)
        n = copt.grid_points_for(float(CAPS.sum()), 10.0)
        probs = copt.build_copt(caps, jnp.asarray(FOR_), 10.0, n)
        l0, _ = copt.lole_eue(probs, 10.0, float(CAPS.sum()),
                              jnp.asarray(load))
        l1, _ = copt.lole_eue_lfu(probs, 10.0, float(CAPS.sum()),
                                  jnp.asarray(load), 50.0)
        assert float(l1) > float(l0)
