"""Core data layer: case data, reliability models, load profile."""
import numpy as np
import pytest

from powersystemsreliabilityassessment.core import cases, load_profile
from powersystemsreliabilityassessment.models import twostate


@pytest.fixture(scope="module")
def rts24():
    return cases.rts24()


class TestRTS24:
    def test_dimensions(self, rts24):
        # 24 buses, 33 units, 38 branches = 71 components (SURVEY.md §2)
        assert rts24.n_bus == 24
        assert rts24.n_gen == 33
        assert rts24.n_branch == 38
        assert rts24.n_comp == 71

    def test_totals(self, rts24):
        assert rts24.total_load == pytest.approx(2850.0)  # RTS-79 peak
        assert rts24.gen_pmax.sum() == pytest.approx(3405.0)

    def test_sync_condenser(self, rts24):
        # Component 15 (1-based) is the bus-14 sync condenser
        assert rts24.gen_pmax[14] == 0.0
        assert rts24.gen_bus[14] == 13
        assert rts24.gen_mttf[14] == 10000.0
        assert rts24.gen_mttr[14] == pytest.approx(0.1)

    def test_u400_units(self, rts24):
        # The two 400 MW units (components 23, 24 1-based) dominate the
        # reference's weak-point ranking; check their data.
        for i in (22, 23):
            assert rts24.gen_pmax[i] == 400.0
            assert rts24.gen_mttf[i] == 1100.0
            assert rts24.gen_mttr[i] == 150.0


class TestTwoState:
    def test_unavailability_formulas(self, rts24):
        u = twostate.unavailability(rts24)
        assert u.shape == (71,)
        # U20 unit: 50/(450+50) = 0.1 (failprob.m:27)
        assert u[0] == pytest.approx(0.1)
        # U400: 150/1250 = 0.12 -> reference FOR
        assert u[22] == pytest.approx(0.12)
        # branch 1: lambda=0.24, mu=8760/16 (failprob.m:31-37)
        assert u[33] == pytest.approx(0.24 / (0.24 + 8760 / 16))

    def test_mean_times(self, rts24):
        mt = twostate.mean_times(rts24)
        assert mt.shape == (71, 2)
        # branch MTTF = 8760/lambda (seqmeantime.m:27)
        assert mt[33, 0] == pytest.approx(8760 / 0.24)
        assert mt[33, 1] == pytest.approx(16.0)

    def test_markov_evolution_limits(self):
        # P(down) converges to the discrete-chain stationary value
        # p01/(p01+p10), which approximates MTTR/(MTTF+MTTR) to ~1%
        # (Markov_process.jl:128 plots the latter as the limit line).
        p = twostate.availability_evolution(1000.0, 50.0, 20000)
        p01, p10 = twostate.transition_probs(1000.0, 50.0)
        assert p[-1] == pytest.approx(p01 / (p01 + p10), rel=1e-6)
        assert p[-1] == pytest.approx(50.0 / 1050.0, rel=0.02)
        assert p[0] == pytest.approx(1 - np.exp(-1 / 1000.0), rel=1e-6)

    def test_rate_estimation(self):
        rng = np.random.default_rng(0)
        ups = -200.0 * np.log(rng.uniform(size=20000))
        downs = -50.0 * np.log(rng.uniform(size=20000))
        mttf, mttr, lam, mu = twostate.estimate_rates(ups, downs)
        assert mttf == pytest.approx(200.0, rel=0.05)
        assert mttr == pytest.approx(50.0, rel=0.05)
        run = twostate.running_lambda_estimate(ups)
        assert run[-1] == pytest.approx(1 / 200.0, rel=0.05)


class TestLoadProfile:
    def test_peak_is_one(self):
        f = load_profile.load_factors()
        assert f.shape == (8736,)
        assert f.max() == pytest.approx(1.0)  # week 51, Tuesday, hour 18
        assert f.min() > 0.2

    def test_hand_computed_hour(self):
        # Hour 1: week 1 (0.862), day formula ceil(mod(1/24,7))=1 -> Monday
        # (0.93), hour-of-day 1, winter weekday (0.67) — anloducurve.m:24-88
        f = load_profile.load_factors()
        assert f[0] == pytest.approx(0.862 * 0.93 * 0.67, rel=1e-12)

    def test_seasons(self):
        f = load_profile.load_factors()
        # week 20 (summer): hour (19*168)+12 uses summer weekday column
        h = 19 * 168 + 11  # 0-based hour 12 of Monday week 20
        assert f[h] == pytest.approx(0.880 * 0.93 * 1.00, rel=1e-12)

    def test_bus_loads_and_weekly_peaks(self, rts24):
        bus, f = load_profile.hourly_bus_loads(rts24.bus_pd, 8736)
        assert bus.shape == (24, 8736)
        assert bus[:, 0].sum() == pytest.approx(2850 * f[0], rel=1e-9)
        wp = load_profile.weekly_peaks(f)
        assert wp.shape == (52,)
        assert wp.max() == pytest.approx(2850.0)

    def test_rts96(self):
        c3 = cases.rts96()
        assert c3.n_bus == 72
        assert c3.n_gen == 99
        assert c3.total_load == pytest.approx(3 * 2850.0)
        # 3x38 in-area branches + the five published inter-area ties
        assert c3.n_branch == 3 * 38 + 5

    def test_replicate_case(self):
        c2 = cases.replicate_case(cases.rts24(), 2)
        assert c2.n_bus == 48
        assert c2.n_branch == 2 * 38 + 2


def test_package_lazy_top_level_api():
    # PEP 562 lazy exports: the main entry points resolve without eager
    # heavy imports at package-import time.
    import powersystemsreliabilityassessment as psra
    assert callable(psra.build_system)
    assert callable(psra.run_nsq_study)
    assert callable(psra.run_seq_study)
    assert callable(psra.evaluate_states)
    assert callable(psra.load_matpower_case)
    assert callable(psra.resolve_case)
    assert hasattr(psra.cases, "rts24")
    assert "run_nsq_study" in dir(psra)
    import pytest as _pytest
    with _pytest.raises(AttributeError):
        psra.nonexistent_symbol
