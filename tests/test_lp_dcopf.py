"""Batched LP solver and DC-OPF evaluator vs. a float64 scipy reference.

This is the formalization of SURVEY.md §4 test strategy item (d): the
batched LP is diffed state-by-state against a CPU reference solver on
enumerated N-1/N-2 contingencies before any Monte Carlo result is trusted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import linprog

from powersystemsreliabilityassessment.core import cases
from powersystemsreliabilityassessment.core.system import build_system
from powersystemsreliabilityassessment.engines import dcopf, lp_ipm
from powersystemsreliabilityassessment.models import twostate
from powersystemsreliabilityassessment.utils.config import CompatFlags, IPMConfig

COMPAT = CompatFlags()
IPM = IPMConfig()


@pytest.fixture(scope="module")
def sys24():
    return build_system(cases.rts24(), COMPAT)


def scipy_dns(sys, down, load_pu):
    """float64 reference solve of the same LP (MW)."""
    gu = jnp.asarray(1.0 - down[: sys.n_gen].astype(np.float64))
    bu = jnp.asarray(1.0 - down[sys.n_gen:].astype(np.float64))
    c, A, b, l, u = dcopf.build_state_lp(sys, gu, bu, jnp.asarray(load_pu),
                                         COMPAT, IPM.theta_max)
    r = linprog(np.asarray(c, np.float64), A_eq=np.asarray(A, np.float64),
                b_eq=np.asarray(b, np.float64),
                bounds=list(zip(np.asarray(l, np.float64),
                                np.asarray(u, np.float64))), method="highs")
    assert r.status == 0, r.message
    return r.fun * sys.base_mva


class TestBoxLP:
    def test_random_lps_vs_scipy(self):
        rng = np.random.default_rng(7)
        for _ in range(10):
            m, n = 6, 16
            A = rng.normal(size=(m, n))
            b = A @ rng.uniform(0.2, 0.8, n)
            c = rng.normal(size=n)
            l, u = np.zeros(n), np.ones(n)
            ref = linprog(c, A_eq=A, b_eq=b, bounds=list(zip(l, u)),
                          method="highs")
            sol = lp_ipm.solve_box_lp(jnp.array(c), jnp.array(A),
                                      jnp.array(b), jnp.array(l),
                                      jnp.array(u), IPM)
            assert float(sol.primal_residual) < 2e-3
            assert float(sol.objective) == pytest.approx(ref.fun, abs=2e-2)

    def test_batch_matches_single(self):
        rng = np.random.default_rng(1)
        m, n, B = 4, 10, 5
        A = rng.normal(size=(B, m, n))
        x0 = rng.uniform(0.3, 0.7, (B, n))
        b = np.einsum("bmn,bn->bm", A, x0)
        c = rng.normal(size=(B, n))
        l = np.zeros((B, n)); u = np.ones((B, n))
        out = lp_ipm.solve_box_lp_batch(jnp.array(c), jnp.array(A),
                                        jnp.array(b), jnp.array(l),
                                        jnp.array(u), IPM)
        for i in range(B):
            one = lp_ipm.solve_box_lp(jnp.array(c[i]), jnp.array(A[i]),
                                      jnp.array(b[i]), jnp.array(l[i]),
                                      jnp.array(u[i]), IPM)
            assert float(out.objective[i]) == pytest.approx(
                float(one.objective), abs=5e-3)


def _peak_loads(sys, n):
    return np.tile(np.asarray(sys.load_pd)[None, :], (n, 1))


class TestDCOPF:
    def test_intact_system_no_shed(self, sys24):
        down = np.zeros((1, 71), bool)
        res = dcopf.evaluate_states(sys24, jnp.asarray(down),
                                    jnp.asarray(_peak_loads(sys24, 1)),
                                    COMPAT, IPM)
        assert float(res.dns_mw[0]) == 0.0
        assert not bool(res.failure[0])

    def test_total_blackout(self, sys24):
        down = np.zeros((1, 71), bool)
        down[0, :33] = True
        res = dcopf.evaluate_states(sys24, jnp.asarray(down),
                                    jnp.asarray(_peak_loads(sys24, 1)),
                                    COMPAT, IPM)
        assert float(res.dns_mw[0]) == pytest.approx(2850.0, abs=0.5)

    def test_capacity_deficit_equals_copper_sheet(self, sys24):
        # Both 400 MW units out at peak: 3405-800 = 2605 < 2850 -> 245 MW
        down = np.zeros((1, 71), bool)
        down[0, 22] = down[0, 23] = True
        res = dcopf.evaluate_states(sys24, jnp.asarray(down),
                                    jnp.asarray(_peak_loads(sys24, 1)),
                                    COMPAT, IPM)
        assert float(res.dns_mw[0]) == pytest.approx(245.0, abs=0.05)
        assert float(res.nodal_mw.sum()) == pytest.approx(245.0, abs=0.1)

    def test_islanding_line_7_8(self, sys24):
        # Line 11 (7-8) outage islands bus 7; island has 300 MW gen vs
        # 125 MW load -> no shed anywhere at peak.
        down = np.zeros((1, 71), bool)
        down[0, 33 + 10] = True
        res = dcopf.evaluate_states(sys24, jnp.asarray(down),
                                    jnp.asarray(_peak_loads(sys24, 1)),
                                    COMPAT, IPM)
        assert float(res.dns_mw[0]) == 0.0

    def test_n1_lines_vs_scipy(self, sys24):
        B = 38
        down = np.zeros((B, 71), bool)
        for i in range(B):
            down[i, 33 + i] = True
        loads = _peak_loads(sys24, B)
        res = dcopf.evaluate_states(sys24, jnp.asarray(down),
                                    jnp.asarray(loads), COMPAT, IPM)
        for i in range(0, B, 7):  # spot-check subset (scipy is slow)
            ref = scipy_dns(sys24, down[i], loads[i])
            ref = 0.0 if ref < COMPAT.dns_noise_floor_mw else ref
            assert float(res.dns_mw[i]) == pytest.approx(ref, abs=0.5)

    def test_random_states_vs_scipy(self, sys24):
        rng = np.random.default_rng(11)
        u = twostate.unavailability(cases.rts24())
        B = 24
        down = rng.uniform(size=(B, 71)) < u[None, :]
        down[:, 14] = False
        loads = _peak_loads(sys24, B)
        res = dcopf.evaluate_states(sys24, jnp.asarray(down),
                                    jnp.asarray(loads), COMPAT, IPM)
        bound = dcopf.copper_sheet_bound(sys24, jnp.asarray(down),
                                         jnp.asarray(loads))
        for i in range(B):
            ref = scipy_dns(sys24, down[i], loads[i])
            ref = 0.0 if ref < COMPAT.dns_noise_floor_mw else ref
            assert float(res.dns_mw[i]) == pytest.approx(ref, abs=0.6)
            # LP shed can never beat the copper-sheet bound
            assert float(res.dns_mw[i]) >= float(bound[i]) - 0.2

    def test_screened_matches_full(self, sys24):
        rng = np.random.default_rng(5)
        u = twostate.unavailability(cases.rts24())
        B = 32
        down = rng.uniform(size=(B, 71)) < u[None, :]
        down[:, 14] = False
        loads = _peak_loads(sys24, B)
        full = dcopf.evaluate_states(sys24, jnp.asarray(down),
                                     jnp.asarray(loads), COMPAT, IPM)
        scr, n_over = dcopf.evaluate_states_screened(
            sys24, jnp.asarray(down), jnp.asarray(loads), B, COMPAT, IPM)
        assert int(n_over) == 0
        np.testing.assert_allclose(np.asarray(scr.dns_mw),
                                   np.asarray(full.dns_mw), atol=0.5)
        assert (np.asarray(scr.failure) == np.asarray(full.failure)).all()

    def test_scaled_load_seq_style(self, sys24):
        # Half load, one U400 out: plenty of margin -> no shed.
        down = np.zeros((1, 71), bool)
        down[0, 22] = True
        loads = 0.5 * _peak_loads(sys24, 1)
        res = dcopf.evaluate_states(sys24, jnp.asarray(down),
                                    jnp.asarray(loads), COMPAT, IPM)
        assert float(res.dns_mw[0]) == 0.0


class TestIslandBlackout:
    def test_compat_flag_sheds_island(self, sys24):
        import dataclasses as dc
        compat_ib = dc.replace(COMPAT, island_blackout=True)
        down = np.zeros((2, 71), bool)
        down[0, 33 + 10] = True   # line 7-8 out -> bus 7 islands
        loads = _peak_loads(sys24, 2)
        res = dcopf.evaluate_states(sys24, jnp.asarray(down),
                                    jnp.asarray(loads), compat_ib, IPM)
        # island blackout: bus-7 load (125 MW) recorded as shed
        assert float(res.dns_mw[0]) == pytest.approx(125.0, abs=1.0)
        assert float(res.nodal_mw[0, 6]) == pytest.approx(125.0, abs=1.0)
        # intact state unaffected
        assert float(res.dns_mw[1]) == 0.0
        # default physics: no shed
        res0 = dcopf.evaluate_states(sys24, jnp.asarray(down),
                                     jnp.asarray(loads), COMPAT, IPM)
        assert float(res0.dns_mw[0]) == 0.0

    def test_connectivity(self, sys24):
        br_up = np.ones((2, 38), np.float32)
        br_up[1, 10] = 0.0
        reach = dcopf.connected_to_ref(sys24, jnp.asarray(br_up))
        assert bool(reach[0].all())
        assert not bool(reach[1, 6])       # bus 7 cut off
        assert bool(reach[1, [0, 1, 2, 7, 23]].all())


class TestFastNodalMode:
    def test_totals_match_lp_mode(self, sys24):
        rng = np.random.default_rng(17)
        u = twostate.unavailability(cases.rts24())
        B = 32
        down = rng.uniform(size=(B, 71)) < u[None, :]
        down[:, 14] = False
        loads = _peak_loads(sys24, B)
        lp, over1 = dcopf.evaluate_states_screened(
            sys24, jnp.asarray(down), jnp.asarray(loads), B, COMPAT, IPM,
            "lp")
        fast, over2 = dcopf.evaluate_states_screened(
            sys24, jnp.asarray(down), jnp.asarray(loads), B, COMPAT, IPM,
            "proportional")
        assert int(over1) == 0 and int(over2) == 0
        # totals and flags identical; only the nodal SPLIT may differ
        np.testing.assert_allclose(np.asarray(fast.dns_mw),
                                   np.asarray(lp.dns_mw), atol=0.5)
        assert (np.asarray(fast.failure) == np.asarray(lp.failure)).all()
        np.testing.assert_allclose(np.asarray(fast.nodal_mw.sum(axis=1)),
                                   np.asarray(lp.nodal_mw.sum(axis=1)),
                                   atol=0.5)


def test_enforce_pmin_overgeneration_degrades_gracefully(sys24):
    # With Pmin enforced, very low load makes the LP infeasible (committed
    # minimum generation exceeds demand). MATPOWER fails and the reference
    # records zero (seqMain.m:117-126); our quality guard degrades the lane
    # to the certified copper bound = 0 as well — same outcome, but logged
    # via the quality score instead of silent.
    import dataclasses as dc
    compat_pm = dc.replace(COMPAT, enforce_pmin=True)
    down = np.zeros((1, 71), bool)
    loads = 0.28 * _peak_loads(sys24, 1)   # ~800 MW < sum(Pmin) ~ 988 MW
    res = dcopf.evaluate_states(sys24, jnp.asarray(down),
                                jnp.asarray(loads), compat_pm, IPM)
    assert float(res.dns_mw[0]) == 0.0
    # ... and — unlike the reference — the infeasibility is DETECTED and
    # flagged, not silent.
    assert bool(res.infeasible[0])
    # A peak-load state with the same fleet is feasible -> not flagged.
    res_peak = dcopf.evaluate_states(sys24, jnp.asarray(down),
                                     jnp.asarray(_peak_loads(sys24, 1)),
                                     compat_pm, IPM)
    assert not bool(res_peak.infeasible[0])
    # Screened path carries the same flags.
    scr, _ = dcopf.evaluate_states_screened(
        sys24, jnp.asarray(down), jnp.asarray(loads), 8, compat_pm, IPM)
    assert bool(scr.infeasible[0])
    # Default compat (enforce_pmin=False): never infeasible.
    res_def = dcopf.evaluate_states(sys24, jnp.asarray(down),
                                    jnp.asarray(loads), COMPAT, IPM)
    assert not bool(res_def.infeasible[0])


def test_pair_outage_certificate_flows_exact(sys24):
    # Exact rank-2 update check: certificate post-outage flows for a
    # 2-line outage must match flows computed on the reduced network.
    rng = np.random.default_rng(23)
    pairs = [(1, 3), (20, 21), (23, 25), (28, 33)]
    inj = rng.normal(size=24).astype(np.float64)
    inj[0] -= inj.sum()  # balanced injections
    import numpy.linalg as la
    inc = np.asarray(sys24.incidence, np.float64)
    bsus = np.asarray(sys24.b_susceptance, np.float64)
    a = np.asarray(sys24.br_transfer, np.float64)
    ptdf = np.asarray(sys24.ptdf, np.float64)
    f0 = ptdf @ inj
    for k1, k2 in pairs:
        # rank-2 woodbury as in certify_states
        E = np.array([[1 - a[k1, k1], -a[k1, k2]],
                      [-a[k2, k1], 1 - a[k2, k2]]])
        c = la.solve(E, np.array([f0[k1], f0[k2]]))
        post = f0 + a[:, k1] * c[0] + a[:, k2] * c[1]
        # direct: rebuild PTDF without lines k1,k2
        keep = np.ones(38, bool); keep[[k1, k2]] = False
        inc2, b2 = inc[keep], bsus[keep]
        bbus = inc2.T @ (b2[:, None] * inc2)
        ptdf2 = np.zeros((keep.sum(), 24))
        ptdf2[:, 1:] = (b2[:, None] * inc2[:, 1:]) @ la.inv(bbus[1:, 1:])
        f2 = ptdf2 @ inj
        np.testing.assert_allclose(post[keep], f2, atol=1e-6)


def test_multi_outage_certificate_flows_exact(sys24):
    # Exact rank-k update check (k = 3, 4): certificate post-outage flows
    # for 3- and 4-line outage sets must match flows computed on the
    # reduced network (same construction as the rank-2 test above).
    rng = np.random.default_rng(31)
    sets = [(1, 3, 20), (5, 9, 30), (1, 3, 20, 33), (2, 12, 25, 31)]
    inj = rng.normal(size=24).astype(np.float64)
    inj[0] -= inj.sum()
    import numpy.linalg as la
    inc = np.asarray(sys24.incidence, np.float64)
    bsus = np.asarray(sys24.b_susceptance, np.float64)
    a = np.asarray(sys24.br_transfer, np.float64)
    ptdf = np.asarray(sys24.ptdf, np.float64)
    f0 = ptdf @ inj
    for ks in sets:
        ks = list(ks)
        E = np.eye(len(ks)) - a[np.ix_(ks, ks)]
        c = la.solve(E, f0[ks])
        post = f0 + a[:, ks] @ c
        keep = np.ones(38, bool)
        keep[ks] = False
        inc2, b2 = inc[keep], bsus[keep]
        bbus = inc2.T @ (b2[:, None] * inc2)
        ptdf2 = np.zeros((keep.sum(), 24))
        ptdf2[:, 1:] = (b2[:, None] * inc2[:, 1:]) @ la.inv(bbus[1:, 1:])
        np.testing.assert_allclose(post[keep], ptdf2 @ inj, atol=1e-6)


def test_multi_outage_certified_lanes_match_oracle(sys24):
    """Forced 3- and 4-branch-outage states: every lane the rank-4
    Woodbury certificate closes must agree with the f64 HiGHS oracle
    (the certificate claims PROVABLE optimality), the rank-2 setting
    must leave all of them uncertified (they were LP-routed before),
    and the uncertified remainder must solve through the LP to the
    oracle as usual."""
    ng = sys24.n_gen
    rng = np.random.default_rng(77)
    B = 24
    down = np.zeros((B, sys24.n_comp), bool)
    for i in range(B):
        k = 3 if i % 2 == 0 else 4
        down[i, ng + rng.choice(38, size=k, replace=False)] = True
        # random moderate gen outages on top
        down[i, rng.choice(ng, size=3, replace=False)] = True
    down[:, 14] = False                       # pinned sync condenser
    load = jnp.broadcast_to(sys24.load_pd[None, :], (B, sys24.n_load))

    cert4 = dcopf.certify_states(sys24, jnp.asarray(down), load,
                                 woodbury_k=4)
    cert2 = dcopf.certify_states(sys24, jnp.asarray(down), load,
                                 woodbury_k=2)  # the default
    c4 = np.asarray(cert4.certified)
    assert not np.asarray(cert2.certified).any()
    assert c4.sum() >= B // 2      # rank-4 closes a real fraction

    res = dcopf.evaluate_states(sys24, jnp.asarray(down), load, COMPAT, IPM)
    for i in range(B):
        ref = scipy_dns(sys24, down[i], np.asarray(load)[i])
        if c4[i]:
            # certified: the copper bound must BE the optimum
            assert float(cert4.deficit[i]) * 100.0 == pytest.approx(
                ref, abs=0.05), f"lane {i}"
        assert float(res.dns_mw[i]) == pytest.approx(ref, abs=0.25), \
            f"lane {i}"


def test_baseline_report_intact_system():
    from powersystemsreliabilityassessment.engines import dcopf as d
    sys_ = build_system(cases.rts24())
    r = d.baseline_report(sys_)
    assert r["capacity_feasible"]
    assert abs(r["capacity_mw"] - 3405.0) < 1.0
    assert abs(r["peak_load_mw"] - 2850.0) < 1.0
    assert 0.0 < r["max_line_loading"] < 1.0  # RTS-24 intact is uncongested


def test_nan_lane_degrades_not_propagates(sys24):
    """A double-line islanding state (branches 6 & 26 down) blows up the
    CPU float32 IPM iterate to NaN; the quality guard must catch the
    non-finite score (NaN > tol is False!) and degrade the lane to the
    certified copper bound instead of returning NaN, matching the f64
    oracle's value within the LP's noise or bounding it from below."""
    ng = sys24.n_gen
    down = np.zeros((1, sys24.n_comp), bool)
    down[0, ng + 6] = True
    down[0, ng + 26] = True
    load = jnp.broadcast_to(sys24.load_pd[None, :], (1, sys24.n_load))
    res = dcopf.evaluate_states(sys24, jnp.asarray(down), load, COMPAT, IPM)
    dns = float(res.dns_mw[0])
    assert np.isfinite(dns)
    ref = scipy_dns(sys24, down[0], np.asarray(load)[0])
    # Either the lane solved (matches oracle) or it degraded to the
    # copper-sheet LOWER bound (<= oracle, never an overestimate).
    assert dns <= ref + 0.05


def test_post_outage_repair_certifies_n1_lanes(sys24):
    """The repair descent operates on LODF-corrected post-outage flows, so
    it certifies single-line-outage lanes whose FIRST candidate congests
    the reduced network (previously ~90% of LP-routed lanes at peak).
    Every lane it newly certifies must carry a provably optimal value:
    deficit == f64 LP optimum, and the certificate's shed/dispatch pattern
    must be feasible on the reduced network (balanced + within rates)."""
    from powersystemsreliabilityassessment.sampling.state import (
        sample_states)
    ng = sys24.n_gen
    # Production state distribution at peak load (pure N-1 on an
    # otherwise-intact fleet never congests RTS-24; the repair-worthy
    # lanes are gen-outage + single-line-outage combinations).
    down = sample_states(jax.random.key(42), sys24.unavail,
                         sys24.always_up_nsq, 16384)
    load = jnp.broadcast_to(sys24.load_pd[None, :],
                            (down.shape[0], sys24.n_load))
    quick = dcopf.certify_states(sys24, down, load, repair_iters=0)
    full = dcopf.certify_states(sys24, down, load, repair_iters=3)
    n_line_out = np.asarray(jnp.sum(down[:, ng:], axis=1))
    rescued = np.asarray(full.certified & ~quick.certified) \
        & (n_line_out == 1)
    assert rescued.any(), "expected repair to rescue some N-1 lanes"
    downs = np.asarray(down)

    ptdf = np.asarray(sys24.ptdf, np.float64)
    lodf = np.asarray(sys24.lodf, np.float64)
    cg = np.asarray(sys24.gen_bus_onehot, np.float64)
    cd = np.asarray(sys24.load_onehot, np.float64)
    rate = np.asarray(sys24.br_rate, np.float64)
    for i in np.where(rescued)[0][:12]:
        ref = scipy_dns(sys24, downs[i], np.asarray(load)[i])
        assert float(full.deficit[i]) * sys24.base_mva == pytest.approx(
            ref, abs=0.05)
        # post-outage feasibility of the certificate's pattern (f64)
        shed = np.asarray(full.shed[i], np.float64)
        disp = np.asarray(full.dispatch[i], np.float64)
        inj = cg @ disp + cd @ shed - cd @ np.asarray(load, np.float64)[i]
        assert abs(inj.sum()) < 1e-4  # balanced
        k = int(np.argmax(downs[i][ng:]))
        if np.abs(lodf[:, k]).max() > 1e5:
            continue  # islanding line: sentinel column, covered by the
            #           scipy optimum equality above
        f0 = ptdf @ inj
        post = f0 + lodf[:, k] * f0[k]
        post[k] = 0.0
        assert np.all(np.abs(post) <= rate + 5e-4)


def test_certify_repair_buffer_exact(sys24):
    """Compacted repair (``repair_buffer``) is BIT-IDENTICAL to
    full-batch repair when the buffer covers the needy lanes, and
    degrades safely (certified set only shrinks; totals untouched) when
    it cannot."""
    from powersystemsreliabilityassessment.sampling.state import (
        sample_states)
    down = sample_states(jax.random.key(43), sys24.unavail,
                         sys24.always_up_nsq, 16384)
    load = jnp.broadcast_to(sys24.load_pd[None, :],
                            (down.shape[0], sys24.n_load))
    full = dcopf.certify_states(sys24, down, load)
    comp = dcopf.certify_states(sys24, down, load, repair_buffer=2048)
    assert (np.asarray(full.certified) == np.asarray(comp.certified)).all()
    assert (np.asarray(full.deficit) == np.asarray(comp.deficit)).all()
    assert (np.asarray(full.shed) == np.asarray(comp.shed)).all()
    assert (np.asarray(full.dispatch) == np.asarray(comp.dispatch)).all()
    # repair actually mattered on this batch (the equality is not vacuous)
    quick = dcopf.certify_states(sys24, down, load, repair_iters=0)
    assert (np.asarray(full.certified) & ~np.asarray(quick.certified)).any()

    # overflowing buffer: un-repaired lanes stay uncertified (subset),
    # deficit (the exact bound) is unaffected
    tiny = dcopf.certify_states(sys24, down, load, repair_buffer=1)
    ct, cf = np.asarray(tiny.certified), np.asarray(full.certified)
    assert not (ct & ~cf).any()
    assert (np.asarray(tiny.deficit) == np.asarray(full.deficit)).all()


def test_screened_repair_buffer_invariant(sys24):
    """The screened evaluator returns identical results with and without
    compacted repair (the un-repaired -> LP route resolves the same
    states the certificate would have)."""
    from powersystemsreliabilityassessment.sampling.state import (
        sample_states)
    compat, ipm = CompatFlags(), IPMConfig()
    down = sample_states(jax.random.key(44), sys24.unavail,
                         sys24.always_up_nsq, 4096)
    load = jnp.broadcast_to(sys24.load_pd[None, :],
                            (down.shape[0], sys24.n_load))
    res_a, over_a = dcopf.evaluate_states_screened(
        sys24, down, load, 256, compat, ipm, "proportional")
    res_b, over_b = dcopf.evaluate_states_screened(
        sys24, down, load, 256, compat, ipm, "proportional",
        repair_buffer=dcopf.default_repair_buffer(4096))
    assert int(over_a) == 0 and int(over_b) == 0
    np.testing.assert_array_equal(np.asarray(res_a.dns_mw),
                                  np.asarray(res_b.dns_mw))
    np.testing.assert_array_equal(np.asarray(res_a.nodal_mw),
                                  np.asarray(res_b.nodal_mw))
    np.testing.assert_array_equal(np.asarray(res_a.failure),
                                  np.asarray(res_b.failure))


def test_default_repair_buffer_policy():
    # batch // 8 covers the measured ~7.0% first-check-needy fraction
    # at RTS-24 peak with headroom (18,446 needy of 262144 counted; an
    # earlier batch // 64 policy overflowed).
    assert dcopf.default_repair_buffer(262144) == 32768
    assert dcopf.default_repair_buffer(262144) > 18446
    assert dcopf.default_repair_buffer(1024) == 1024
    assert dcopf.default_repair_buffer(262144, outage_boost=8.0) is None
    # with a calibrated shed hint the needy fraction collapses to
    # ~0.04%, so the hinted buffer shrinks 8x
    assert dcopf.default_repair_buffer(262144, hinted=True) == 4096


def test_shed_hint_calibration_and_equivalence(sys24):
    """calibrate_shed_hint returns a normalized pattern; the hinted
    first pass certifies at least as much as proportional + repair;
    and the screened evaluation's aggregate DNS is unchanged (the hint
    only picks a different point of the same optimal face)."""
    hint = dcopf.calibrate_shed_hint(sys24, batch=4096)
    assert hint is not None and hint.shape == (sys24.n_load,)
    assert abs(float(hint.sum()) - 1.0) < 1e-5
    assert (hint >= 0).all()

    p = jnp.minimum(sys24.unavail * 8.0, 0.5)
    down = (jax.random.uniform(jax.random.key(31), (2048, p.shape[0]))
            < p[None, :]) & ~sys24.always_up_nsq[None, :]
    load = jnp.broadcast_to(sys24.load_pd[None, :],
                            (down.shape[0], sys24.n_load))
    hint_b = jnp.broadcast_to(jnp.asarray(hint)[None, :], load.shape)
    r_hint = dcopf.certify_states(sys24, down, load, shed_hint=hint_b,
                                  repair_iters=0)
    r_prop = dcopf.certify_states(sys24, down, load)
    ch, cp = np.asarray(r_hint.certified), np.asarray(r_prop.certified)
    assert ch.sum() >= 0.99 * cp.sum()
    # certified sheds still sum to the copper deficit
    c = ch
    np.testing.assert_allclose(
        np.asarray(r_hint.shed, np.float64)[c].sum(axis=1),
        np.asarray(r_hint.deficit, np.float64)[c], atol=2e-4)

    compat, ipm = CompatFlags(), IPMConfig()
    res_h, ov_h = dcopf.evaluate_states_screened(
        sys24, down, load, 2048, compat, ipm, "proportional",
        shed_hint=jnp.asarray(hint))
    res_p, ov_p = dcopf.evaluate_states_screened(
        sys24, down, load, 2048, compat, ipm, "proportional")
    assert int(ov_h) == 0 and int(ov_p) == 0
    np.testing.assert_allclose(np.asarray(res_h.dns_mw),
                               np.asarray(res_p.dns_mw), atol=5e-3)
    assert (np.asarray(res_h.failure) == np.asarray(res_p.failure)).all()


@pytest.fixture(scope="module")
def lane_states(sys24):
    """128 RTS-24 lanes: stressed random states plus single-line
    outages, so the flow rows vary across lanes."""
    case = cases.rts24()
    B = 128
    rng = np.random.default_rng(11)
    u = twostate.unavailability(case)
    down = rng.uniform(size=(B, case.n_comp)) < 3 * u[None, :]
    down[:, 14] = False
    down[np.arange(0, B, 3),
         case.n_gen + rng.integers(0, case.n_branch, len(range(0, B, 3)))
         ] = True
    gu = jnp.asarray(1.0 - down[:, :case.n_gen].astype(np.float32))
    bu = jnp.asarray(1.0 - down[:, case.n_gen:].astype(np.float32))
    load = jnp.asarray(np.tile(np.asarray(sys24.load_pd)[None, :], (B, 1)))
    return gu, bu, load


def test_vectors_match_materialized_builder(sys24, lane_states):
    gu, bu, load = lane_states
    c, A, b, l, u = jax.vmap(
        lambda g, br, ld: dcopf.build_state_lp(sys24, g, br, ld, COMPAT,
                                               IPM.theta_max))(gu, bu, load)
    c2, b2, l2, u2, colscale = dcopf.build_state_lp_vectors(
        sys24, gu, bu, load, COMPAT, IPM.theta_max)
    np.testing.assert_array_equal(np.asarray(c), np.asarray(c2))
    np.testing.assert_array_equal(np.asarray(b), np.asarray(b2))
    np.testing.assert_array_equal(np.asarray(l), np.asarray(l2))
    np.testing.assert_array_equal(np.asarray(u), np.asarray(u2))


def test_vectors_match_with_enforce_pmin(sys24, lane_states):
    import dataclasses as dc
    gu, bu, load = lane_states
    compat_pm = dc.replace(COMPAT, enforce_pmin=True)
    c, A, b, l, u = jax.vmap(
        lambda g, br, ld: dcopf.build_state_lp(sys24, g, br, ld, compat_pm,
                                               IPM.theta_max))(gu, bu, load)
    c2, b2, l2, u2, _ = dcopf.build_state_lp_vectors(
        sys24, gu, bu, load, compat_pm, IPM.theta_max)
    np.testing.assert_array_equal(np.asarray(l), np.asarray(l2))
    np.testing.assert_array_equal(np.asarray(u), np.asarray(u2))


_LP_CASES = {
    "rts24": cases.rts24,
    "rts96": cases.rts96,
    "rts24x6": lambda: cases.replicate_case(cases.rts24(), 6),
}


@pytest.mark.parametrize("case_name,B", [
    ("rts24", 5), ("rts24", 37), ("rts96", 3), ("rts96", 11),
    ("rts24x6", 3)])
def test_lp_path_vs_highs_unpadded(case_name, B):
    """The one LP path every device runs (dense IPM up to m = 336, the
    structured block-Schur operator beyond — rts24x6 has m = 384) at
    batch sizes that are no lane multiple: outputs keep shape B, and
    every lane's DNS matches the float64 HiGHS oracle."""
    from powersystemsreliabilityassessment.engines import lp_ipm_batched
    from powersystemsreliabilityassessment.utils import oracle

    case = _LP_CASES[case_name]()
    sys_ = build_system(case, COMPAT)
    rng = np.random.default_rng(B)
    u = twostate.unavailability(case)
    down = rng.uniform(size=(B, case.n_comp)) < 4 * u[None, :]
    down &= ~np.asarray(sys_.always_up_nsq)[None, :]
    # Lane 0 loses the six largest units: a deficit the LP must split.
    down[0, np.argsort(-np.asarray(case.gen_pmax))[:6]] = True
    loads = _peak_loads(sys_, B)

    shed, pg, quality = dcopf._solve_batch(
        sys_, jnp.asarray(down), jnp.asarray(loads), COMPAT, IPM)
    assert shed.shape == (B, sys_.n_load)
    assert pg.shape == (B, sys_.n_gen)
    assert quality.shape == (B,)
    m = sys_.n_bus + sys_.n_branch
    assert (m > lp_ipm_batched._BLOCKED_MAX_M) == (case_name == "rts24x6")

    res = dcopf.evaluate_states(sys_, jnp.asarray(down), jnp.asarray(loads),
                                COMPAT, IPM)
    assert res.dns_mw.shape == (B,)
    dns = np.asarray(res.dns_mw, np.float64)
    assert dns[0] > 1.0
    for i in range(B):
        ref = oracle.highs_dns(sys_, down[i], loads[i], COMPAT,
                               IPM.theta_max)
        assert dns[i] == pytest.approx(ref, abs=0.05), (i, dns[i], ref)


@pytest.mark.parametrize("m", [5, 62, 337])
def test_chol_ops_solve_matches_numpy(m):
    """``_make_chol_ops``: XLA's batched Cholesky up to _BLOCKED_MAX_M,
    the all-matmul blocked factor beyond — both solve an equilibrated
    SPD batch to f32 accuracy."""
    from powersystemsreliabilityassessment.engines import lp_ipm_batched

    rng = np.random.default_rng(m)
    G = rng.normal(size=(3, m, m + 4))
    M = G @ np.swapaxes(G, 1, 2) + m * np.eye(m)
    d = 1.0 / np.sqrt(np.einsum("bii->bi", M))
    M = M * d[:, :, None] * d[:, None, :]
    r = rng.normal(size=(3, m))
    factor, solve = lp_ipm_batched._make_chol_ops(m)
    F = factor(jnp.asarray(M, jnp.float32))
    assert isinstance(F, tuple) == (m > lp_ipm_batched._BLOCKED_MAX_M)
    x = np.asarray(solve(F, jnp.asarray(r, jnp.float32)), np.float64)
    np.testing.assert_allclose(x, np.linalg.solve(M, r[..., None])[..., 0],
                               atol=2e-4)
