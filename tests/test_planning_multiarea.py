"""Planning features (maintenance/ELU/LFU), multi-area engine, and the
educational studies."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from powersystemsreliabilityassessment.engines import elu as elu_mod
from powersystemsreliabilityassessment.engines import multiarea, planning
from powersystemsreliabilityassessment.studies import (
    hl1_comparison, markov_education, multiarea_demo, planning_elu)


class TestMaintenance:
    def test_levelization_avoids_peaks(self):
        fleet = planning_elu.demo_planning_fleet()
        peaks = np.full(52, 800.0)
        peaks[20:30] = 1100.0  # high-load block: maintenance must avoid it
        planning.schedule_maintenance(fleet, peaks)
        mask = planning.maintenance_mask(fleet)
        # no maintenance capacity removed during the stressed weeks
        removed = (mask * fleet.capacity[None, :]).sum(axis=1)
        assert removed[20:30].sum() == 0
        # every unit with maint_weeks > 0 got scheduled
        assert (fleet.maint_start[fleet.maint_weeks > 0] > 0).all()

    def test_mask_durations(self):
        fleet = planning_elu.demo_planning_fleet()
        planning.schedule_maintenance(fleet, np.full(52, 800.0))
        mask = planning.maintenance_mask(fleet)
        np.testing.assert_array_equal(mask.sum(axis=0), fleet.maint_weeks)


class TestELU:
    def test_generous_limit_keeps_q(self):
        fleet = planning_elu.demo_planning_fleet(hydro_hours=1e6)
        load = planning_elu.demo_planning_load(seed=1)
        planning.iterate_elu(fleet, load, 50.0, 20.0, iters=2)
        assert fleet.effective_q[4] == pytest.approx(fleet.for_rate[4])

    def test_tight_limit_raises_q(self):
        fleet = planning_elu.demo_planning_fleet(hydro_hours=50.0)
        load = planning_elu.demo_planning_load(seed=1)
        planning.iterate_elu(fleet, load, 50.0, 20.0, iters=3)
        assert fleet.effective_q[4] > fleet.for_rate[4]

    def test_mc_dispatch_semantics(self):
        # 1 unlimited 100 MW unit + 1 ELU 50 MW with 2 MWh of energy;
        # constant 120 MW load, no failures, no maintenance, no LFU:
        # hours 1-2 served by draining 20 MWh? No: proportional drain uses
        # 'share of unserved': unserved = 20 -> drain 20/h; energy 2 MWh
        # lasts 0.1 h -> exhausted after ceil: hour 1 drains 20 (> limit),
        # so from hour 2 on the ELU is exhausted -> deficit 20.
        lole_y, hourly = elu_mod.run_elu_mc(
            jax.random.key(0),
            jnp.asarray([100.0, 50.0]), jnp.asarray([0.0, 0.0]),
            jnp.asarray([0, 0]), jnp.asarray([0, 0]),
            jnp.asarray([jnp.inf, 2.0]),
            jnp.full((24,), 120.0), 0.0, 4)
        # hour 0 is covered (energy available), rest in deficit
        assert float(hourly[0]) == 0.0
        assert float(hourly[1:].mean()) == 1.0
        assert float(lole_y.mean()) == 23.0

    def test_var_cvar(self):
        s = jnp.asarray(np.arange(100, dtype=np.float32))
        var, cvar = elu_mod.var_cvar(s, 0.95)
        assert float(var) == 94.0
        assert float(cvar) == pytest.approx(np.mean([94, 95, 96, 97, 98, 99]))


class TestPlanningStudies:
    def test_analytical_vs_mc_generous_elu(self):
        # The MCvsMarkovProcess "600 h of water" configuration must meet
        # the reference's own <20% agreement gate (jl:330-335).
        fleet = planning_elu.demo_planning_fleet(hydro_hours=600.0)
        load = planning_elu.demo_planning_load(seed=3)
        res = planning_elu.run_elu_comparison(fleet, load, mc_years=400,
                                              seed=4)
        assert res.analytical_lole > 0
        assert res.success, (res.analytical_lole, res.mc_lole)

    def test_tail_risk_mc_exceeds_analytical(self):
        # tail_risk.jl's 50-hour water shortage: sequential energy
        # exhaustion produces more risk than the effective-q analytical
        # approximation captures -> MC mean above analytical, heavy tail.
        res = planning_elu.run_tail_risk_study(mc_years=300, seed=5)
        assert res.mc_lole > res.analytical_lole
        assert res.cvar95 >= res.var95 >= res.mc_lole


class TestMultiArea:
    def test_interconnection_helps(self):
        res = multiarea_demo.run_demo(n_years=20, seed=1, hours=2000)
        iso = res[multiarea.ISOLATED]
        inter = res[multiarea.INTERCONNECTED]
        for a in range(2):
            assert inter["eue"][a] <= iso["eue"][a] + 1e-6
        assert sum(inter["eue"]) < sum(iso["eue"])

    def test_flow_conservation_cases(self):
        m = jnp.asarray([[-5.0, 3.0, 4.0]])
        tf = jnp.asarray([0, 1], jnp.int32)
        tt = jnp.asarray([1, 2], jnp.int32)
        # chain 0-1-2 with big caps: area 0 can import from both
        out = multiarea.solve_curtailment(m, tf, tt,
                                          jnp.asarray([10.0, 10.0]))
        assert float(out[0, 0]) == pytest.approx(0.0, abs=1e-3)
        # tie caps 1 each: only 1 MW reaches area 0 (0-1 link binds)
        out = multiarea.solve_curtailment(m, tf, tt,
                                          jnp.asarray([1.0, 1.0]))
        assert float(out[0, 0]) == pytest.approx(4.0, abs=1e-2)

    def test_three_area_closed_form(self):
        # A(+100) -- 30 --> B(-50), B -- 40 --> C(-80), A -- 10 --> C.
        # B keeps all 30 it can import (curtails 20); C gets only the
        # direct 10 from A (B has no surplus to forward), curtails 70.
        m = jnp.asarray([[100.0, -50.0, -80.0]])
        tf = jnp.asarray([0, 1, 0], jnp.int32)
        tt = jnp.asarray([1, 2, 2], jnp.int32)
        caps = jnp.asarray([30.0, 40.0, 10.0])
        out = multiarea.solve_curtailment(m, tf, tt, caps)
        assert float(out[0, 0]) == pytest.approx(0.0, abs=1e-3)
        assert float(out[0, 1]) == pytest.approx(20.0, abs=0.1)
        assert float(out[0, 2]) == pytest.approx(70.0, abs=0.1)

    def test_random_topologies_match_f64_lp_oracle(self):
        # Randomized optimality: TOTAL curtailment from the engine (f32
        # IPM + closed-form repair, surplus-only cap, flow tiebreak) must
        # equal the float64 HiGHS optimum of the uncapped min-total-
        # curtailment LP. (The surplus-only cap and the 1e-3 flow
        # tiebreak change only the per-area split among degenerate
        # optima, never the total — this pins exactly that claim.)
        from scipy.optimize import linprog
        rng = np.random.default_rng(17)
        for trial in range(12):
            A = int(rng.integers(2, 6))
            T = int(rng.integers(1, 2 * A))
            tf = rng.integers(0, A, T)
            tt = (tf + rng.integers(1, A, T)) % A        # no self-loops
            cap = rng.uniform(5.0, 80.0, T)
            m = rng.uniform(-100.0, 120.0, (4, A))
            out = multiarea.solve_curtailment(
                jnp.asarray(m, jnp.float32), jnp.asarray(tf, jnp.int32),
                jnp.asarray(tt, jnp.int32), jnp.asarray(cap, jnp.float32))
            inc = np.zeros((A, T))
            np.add.at(inc, (tt, np.arange(T)), 1.0)
            np.add.at(inc, (tf, np.arange(T)), -1.0)
            for b in range(m.shape[0]):
                # min sum(c) s.t. c + inc@(f+ - f-) >= -margin, c,f >= 0
                A_ub = np.concatenate([-np.eye(A), -inc, inc], axis=1)
                res = linprog(
                    c=np.concatenate([np.ones(A), np.zeros(2 * T)]),
                    A_ub=A_ub, b_ub=m[b],
                    bounds=[(0, None)] * A + [(0, c) for c in cap] * 2,
                    method="highs")
                assert res.status == 0
                total = float(jnp.sum(out[b]))
                assert total == pytest.approx(res.fun, abs=0.15), (
                    trial, b, total, res.fun)
                # ...and each area never exceeds its isolated deficit.
                assert np.all(np.asarray(out[b])
                              <= np.maximum(-m[b], 0.0) + 1e-3)

    def test_areas_from_case_rts96(self):
        from powersystemsreliabilityassessment.core import cases
        case = cases.rts96()
        sys = multiarea.areas_from_case(
            case, np.arange(case.n_bus) // 24, np.ones(10))
        assert sys.n_areas == 3
        # 5 published inter-area ties; A-B capability 175+500+500 = 1175
        assert sys.tie_cap.shape == (5,)
        ab = sys.tie_cap[((sys.tie_from == 0) & (sys.tie_to == 1))
                         | ((sys.tie_from == 1) & (sys.tie_to == 0))]
        assert ab.sum() == pytest.approx(1175.0)
        # per-area fleet: 32 real units (sync condenser dropped), 3405 MW
        for a in range(3):
            assert len(sys.gen_capacity[a]) == 32
            assert sys.gen_capacity[a].sum() == pytest.approx(3405.0)
        # per-area peak load = RTS-24 system peak
        assert sys.hourly_load[:, 0] == pytest.approx(2850.0)

    def test_nring_interconnection_helps(self):
        out = multiarea_demo.run_nring_demo(n_areas=4, n_years=3,
                                            hours=800)
        iso = out[multiarea.ISOLATED]
        inter = out[multiarea.INTERCONNECTED]
        assert len(iso["lole"]) == 4
        for a in range(4):
            assert inter["eue"][a] <= iso["eue"][a] + 1e-6


class TestShardedEngines:
    """psum-reduction wiring of the mesh-sharded multi-area and HL1 MC
    engines (VERDICT r1 item 7): the 8-device shard_map result must equal
    the serial sum over the per-device computations with the same
    fold_in(key, device) scheme."""

    def test_multiarea_sharded_equals_serial(self):
        from powersystemsreliabilityassessment.parallel import (
            mesh as meshlib)
        from powersystemsreliabilityassessment.sampling import (
            chronological)
        from powersystemsreliabilityassessment.utils.config import (
            IPMConfig)

        sys = multiarea_demo.demo_system(hours=500)
        mesh = meshlib.scenario_mesh()
        n_dev = mesh.devices.size
        ypd = 2
        ipm = IPMConfig(iterations=20)
        step = multiarea.make_multiarea_batch_step(
            sys, mesh, ypd, multiarea.INTERCONNECTED, ipm)
        key = jax.random.key(3)
        lh, es = step(key)

        # Serial replication of every device's block.
        caps, mttf, mttr = multiarea._padded_fleet(sys)
        H = sys.hourly_load.shape[1]
        A = sys.n_areas
        nd = chronological.default_num_draws(
            mttf.reshape(-1), mttr.reshape(-1), H)
        exp_lh = np.zeros(A)
        exp_es = np.zeros(A)
        for dev in range(n_dev):
            keys = jax.random.split(jax.random.fold_in(key, dev), ypd)
            down = jax.vmap(lambda kk: chronological.sample_timeline(
                kk, jnp.asarray(mttf.reshape(-1), jnp.float32),
                jnp.asarray(mttr.reshape(-1), jnp.float32), H, nd,
                quantize=False))(keys)
            avail = 1.0 - down.astype(jnp.float32)
            cap_series = jnp.einsum(
                "yagh,ag->yah",
                avail.reshape(ypd, A, caps.shape[1], H),
                jnp.asarray(caps))
            margins = (jnp.swapaxes(cap_series, 1, 2)
                       - jnp.asarray(sys.hourly_load,
                                     jnp.float32).T[None])
            curt = multiarea.solve_curtailment(
                margins.reshape(-1, A),
                jnp.asarray(sys.tie_from, jnp.int32),
                jnp.asarray(sys.tie_to, jnp.int32),
                jnp.asarray(sys.tie_cap, jnp.float32),
                multiarea.INTERCONNECTED, ipm)
            exp_lh += np.asarray(jnp.sum(curt > 0, axis=0), np.float64)
            exp_es += np.asarray(jnp.sum(curt, axis=0), np.float64)
        np.testing.assert_allclose(np.asarray(lh), exp_lh, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(es), exp_es, rtol=1e-4)

    def test_hl1_nsq_sharded_equals_serial(self):
        from powersystemsreliabilityassessment.engines import (
            copper_sheet)
        from powersystemsreliabilityassessment.parallel import (
            mesh as meshlib)

        gens = hl1_comparison.demo_fleet()
        load = hl1_comparison.sinusoidal_load(seed=4)[:2000]
        mesh = meshlib.scenario_mesh()
        n_dev = mesh.devices.size
        res = hl1_comparison.run_non_sequential_mc(
            gens, load, iterations=n_dev * 64, seed=7, batch=n_dev * 64,
            mesh=mesh)
        caps = jnp.asarray([g.capacity for g in gens], jnp.float32)
        fors = jnp.asarray([g.for_rate for g in gens], jnp.float32)
        curve = copper_sheet.LoadCurve.build(jnp.asarray(load))
        key = jax.random.fold_in(jax.random.key(7), 0)
        tot_l = tot_e = 0.0
        for dev in range(n_dev):
            lole, eue, _ = copper_sheet.nsq_batch(
                jax.random.fold_in(key, dev), caps, fors, curve, 64)
            tot_l += float(lole.sum()); tot_e += float(eue.sum())
        n = n_dev * 64
        assert res.lole_hours_yr == pytest.approx(tot_l / n, rel=1e-6)
        assert res.eue_mwh_yr == pytest.approx(tot_e / n, rel=1e-5)


class TestHL1Comparison:
    def test_three_engines_agree(self):
        gens = hl1_comparison.demo_fleet()
        load = hl1_comparison.sinusoidal_load(seed=2)
        ana = hl1_comparison.run_analytical(gens, load)
        nsq = hl1_comparison.run_non_sequential_mc(gens, load, 4000, seed=2)
        seq = hl1_comparison.run_sequential_mc(gens, load, 300, seed=3)
        assert nsq.lole_hours_yr == pytest.approx(ana.lole_hours_yr,
                                                  rel=0.25)
        assert seq.lole_hours_yr == pytest.approx(ana.lole_hours_yr,
                                                  rel=0.3)
        table = hl1_comparison.compare_results([ana, nsq, seq])
        assert "Analytical" in table and "Sequential MC" in table


class TestEducational:
    def test_exponential_proof(self):
        times, t, pdf = markov_education.exponential_proof(1000.0, 20000)
        # empirical mean of geometric(p01) ~ discrete exponential mean
        assert np.mean(times) == pytest.approx(1000.0, rel=0.1)

    def test_single_component(self):
        s = markov_education.single_component_study()
        assert s.prob_down_analytical[-1] == pytest.approx(
            s.steady_state, rel=0.05)
        assert set(np.unique(s.mc_realization)) <= {0, 1}

    def test_capacity_series(self):
        cap, total = markov_education.multi_unit_capacity_series()
        assert total == 600.0
        assert cap.max() <= total
        assert cap.min() >= 0

    def test_estimation(self):
        s = markov_education.parameter_estimation_study()
        assert s.running_lambda[-1] == pytest.approx(s.true_lambda, rel=0.1)


def test_three_area_rts96_hl15():
    from powersystemsreliabilityassessment.studies import multiarea_demo
    out = multiarea_demo.run_rts96_hl15(n_years=4, hours=1000)
    iso = out[multiarea.ISOLATED]
    inter = out[multiarea.INTERCONNECTED]
    assert len(iso["lole"]) == 3
    assert sum(inter["eue"]) <= sum(iso["eue"]) + 1e-6


@pytest.mark.parametrize("B", [1, 5, 129])
def test_solve_curtailment_any_batch_matches_f64_lp(B):
    """solve_curtailment runs any batch size as is (no lane padding):
    shape [B, A], and each row's total equals the float64 HiGHS
    optimum of the min-total-curtailment LP."""
    from scipy.optimize import linprog
    rng = np.random.default_rng(B)
    A, tf, tt = 3, np.array([0, 1, 0]), np.array([1, 2, 2])
    cap = np.array([30.0, 40.0, 10.0])
    m = rng.uniform(-100.0, 120.0, (B, A))
    out = np.asarray(multiarea.solve_curtailment(
        jnp.asarray(m, jnp.float32), jnp.asarray(tf, jnp.int32),
        jnp.asarray(tt, jnp.int32), jnp.asarray(cap, jnp.float32)))
    assert out.shape == (B, A)
    inc = np.zeros((A, 3))
    np.add.at(inc, (tt, np.arange(3)), 1.0)
    np.add.at(inc, (tf, np.arange(3)), -1.0)
    for b in range(0, B, max(B // 8, 1)):
        res = linprog(c=np.concatenate([np.ones(A), np.zeros(6)]),
                      A_ub=np.concatenate([-np.eye(A), -inc, inc], axis=1),
                      b_ub=m[b], bounds=[(0, None)] * A
                      + [(0, c) for c in cap] * 2, method="highs")
        assert res.status == 0
        assert out[b].sum() == pytest.approx(res.fun, abs=0.15)
