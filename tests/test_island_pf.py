"""Tier-1.5 island-aware reduced-network PF certificate vs float64 HiGHS.

Soundness contract: every lane ``certify_island_pf`` certifies must have
LP-optimal DNS equal to its per-island copper bound (the certificate's
claim), verified against the float64 oracle on engineered islanding
states, deep multi-branch outage states, and random mixtures. The bound
itself must bracket the oracle from below on EVERY lane (certified or
not) — it is used as the overflow fallback.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from powersystemsreliabilityassessment.core import cases
from powersystemsreliabilityassessment.core.system import build_system
from powersystemsreliabilityassessment.engines import dcopf
from powersystemsreliabilityassessment.utils.config import (
    CompatFlags, IPMConfig)

from test_lp_dcopf import scipy_dns

COMPAT = CompatFlags()
IPM = IPMConfig()


@pytest.fixture(scope="module")
def sys24():
    return build_system(cases.rts24(), COMPAT)


def _cut_branches(sys, bus_set):
    """Branch indices crossing the (bus_set, complement) partition."""
    inc = np.asarray(sys.incidence)
    fr = np.argmax(inc > 0, axis=1)
    to = np.argmax(inc < 0, axis=1)
    in_s = np.zeros(sys.n_bus, bool)
    in_s[list(bus_set)] = True
    return np.nonzero(in_s[fr] != in_s[to])[0]


def _states(sys, seed=0):
    """Mixture: islanding cuts (with/without gen outages), deep
    multi-branch outages, intact, and random heavy states."""
    ng, nl = sys.n_gen, sys.n_branch
    rng = np.random.default_rng(seed)
    rows = [np.zeros(ng + nl, np.float32)]          # intact

    # RTS-24: buses 0-9 form the 138 kV south region; cutting the
    # inter-region corridor islands it.
    cut = _cut_branches(sys, range(10))
    s = np.zeros(ng + nl, np.float32)
    s[ng + cut] = 1.0
    rows.append(s)                                   # pure islanding
    for k in range(6):                               # islanding + gens out
        s2 = s.copy()
        s2[rng.choice(ng, 4 + k, replace=False)] = 1.0
        rows.append(s2)
    cut2 = _cut_branches(sys, [6, 7])                # small island
    s = np.zeros(ng + nl, np.float32)
    s[ng + cut2] = 1.0
    rows.append(s)
    for k in range(4):
        s2 = s.copy()
        s2[rng.choice(ng, 3 + 2 * k, replace=False)] = 1.0
        rows.append(s2)

    for k in range(16):                              # deep multi-branch
        s = np.zeros(ng + nl, np.float32)
        s[ng + rng.choice(nl, 5 + (k % 4), replace=False)] = 1.0
        s[rng.choice(ng, rng.integers(0, 7), replace=False)] = 1.0
        rows.append(s)
    for k in range(16):                              # random heavy
        s = np.zeros(ng + nl, np.float32)
        s[rng.choice(ng + nl, rng.integers(2, 12), replace=False)] = 1.0
        rows.append(s)
    return np.stack(rows)


def test_island_pf_soundness_vs_oracle(sys24):
    states = _states(sys24)
    B = len(states)
    load = jnp.broadcast_to(sys24.load_pd[None, :], (B, sys24.n_load))
    cert = dcopf.certify_island_pf(sys24, jnp.asarray(states), load,
                                   theta_cap=IPM.theta_max)
    certified = np.asarray(cert.certified)
    deficit_mw = np.asarray(cert.deficit) * float(sys24.base_mva)
    # the state mix must actually exercise the certificate
    assert certified.sum() >= B // 2
    assert (deficit_mw > 0).sum() >= 3

    for i in range(B):
        ref = scipy_dns(sys24, states[i], np.asarray(sys24.load_pd))
        # island-copper bound brackets the oracle from below, always
        assert deficit_mw[i] <= ref + 0.05, i
        if certified[i]:
            assert deficit_mw[i] == pytest.approx(ref, abs=0.05), i


def test_island_bound_tightens_copper(sys24):
    states = _states(sys24, seed=3)
    B = len(states)
    load = jnp.broadcast_to(sys24.load_pd[None, :], (B, sys24.n_load))
    cert = dcopf.certify_island_pf(sys24, jnp.asarray(states), load)
    copper_mw = dcopf.copper_sheet_bound(sys24, jnp.asarray(states), load)
    deficit_mw = np.asarray(cert.deficit) * float(sys24.base_mva)
    assert np.all(deficit_mw >= np.asarray(copper_mw) - 1e-3)
    # the candidate pattern respects its caps and totals the bound
    shed = np.asarray(cert.shed)
    assert np.all(shed >= -1e-6)
    assert np.all(shed <= np.asarray(load) + 1e-5)
    np.testing.assert_allclose(shed.sum(axis=1), np.asarray(cert.deficit),
                               atol=2e-4)


def test_screened_with_pf_buffer_matches_oracle(sys24):
    """End-to-end: evaluate_states_screened with pf_buffer on a batch
    containing islanding/deep states returns oracle-correct DNS and
    routes fewer lanes to the LP."""
    states = _states(sys24, seed=5)
    B = len(states)
    pad = (-B) % 8
    states = np.concatenate([states,
                             np.zeros((pad, states.shape[1]), np.float32)])
    B = len(states)
    load = jnp.broadcast_to(sys24.load_pd[None, :], (B, sys24.n_load))
    res_pf, over_pf = dcopf.evaluate_states_screened(
        sys24, jnp.asarray(states), load, max_lp=16, compat=COMPAT,
        ipm=IPM, nodal_mode="proportional", woodbury_k=2, pf_buffer=64)
    res0, over0 = dcopf.evaluate_states_screened(
        sys24, jnp.asarray(states), load, max_lp=64, compat=COMPAT,
        ipm=IPM, nodal_mode="proportional", woodbury_k=2)
    dns_pf = np.asarray(res_pf.dns_mw)
    dns0 = np.asarray(res0.dns_mw)
    assert int(over_pf) == 0
    np.testing.assert_allclose(dns_pf, dns0, atol=0.6)
    for i in range(0, B, 3):        # spot-check a third against f64
        ref = scipy_dns(sys24, states[i], np.asarray(sys24.load_pd))
        ref = 0.0 if ref < COMPAT.dns_noise_floor_mw else ref
        assert dns_pf[i] == pytest.approx(ref, abs=0.6), i
