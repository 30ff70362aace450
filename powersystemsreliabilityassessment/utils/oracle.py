"""float64 HiGHS oracle and the fixed golden-replay state set.

The evaluator solves each state's min-shed LP in float32 on the device;
this module solves the identical LP (``dcopf.build_state_lp``) with
``scipy.optimize.linprog(method="highs")`` in float64 on the host. It is
the reference the LP path is checked against: by
``scripts/golden_replay.py`` on the CPU and by ``chip_smoke.py`` on the
GPU, on the same deterministic state set.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np

GOLDEN_PATH = (pathlib.Path(__file__).resolve().parents[2]
               / "tests" / "golden" / "golden_replay.json")


def highs_dns(sys, down: np.ndarray, load_pu: np.ndarray, compat,
              theta_max: float) -> float:
    """DNS (MW) of one state's LP solved by HiGHS in float64, with the
    reference's noise floor applied."""
    import jax.numpy as jnp
    from scipy.optimize import linprog

    from powersystemsreliabilityassessment.engines import dcopf

    ng = sys.n_gen
    down = np.asarray(down)
    gu = jnp.asarray(1.0 - down[:ng].astype(np.float32))
    bu = jnp.asarray(1.0 - down[ng:].astype(np.float32))
    c, A, b, l, u = dcopf.build_state_lp(sys, gu, bu, jnp.asarray(load_pu),
                                         compat, theta_max)
    r = linprog(np.asarray(c, np.float64), A_eq=np.asarray(A, np.float64),
                b_eq=np.asarray(b, np.float64),
                bounds=list(zip(np.asarray(l, np.float64),
                                np.asarray(u, np.float64))), method="highs")
    if r.status != 0:
        raise RuntimeError(f"HiGHS failed: {r.message}")
    dns = r.fun * float(sys.base_mva)
    return 0.0 if dns < compat.dns_noise_floor_mw else dns


def golden_state_set(case, sys):
    """Deterministic replay set: stressed random states, every N-1 branch
    outage, random N-2 pairs, and off-peak hours. Returns
    ``(downs [S, n_comp] bool, loads [S, n_load], tags)``."""
    from powersystemsreliabilityassessment.models import twostate

    rng = np.random.default_rng(2024)
    u = twostate.unavailability(case)
    nc, nl, ng = case.n_comp, case.n_branch, case.n_gen
    peak = np.asarray(sys.load_pd, np.float64)

    downs, loads, tags = [], [], []
    # 40 stressed random states at peak (3x unavailability -> deficits).
    st = rng.uniform(size=(40, nc)) < 3 * u[None, :]
    st[:, 14] = False
    for i, s in enumerate(st):
        downs.append(s); loads.append(peak); tags.append(f"stress{i}")
    # Every single-branch outage at peak.
    for k in range(nl):
        s = np.zeros(nc, bool); s[ng + k] = True
        downs.append(s); loads.append(peak); tags.append(f"N-1 line{k}")
    # 12 random branch pairs at peak.
    for i in range(12):
        k1, k2 = rng.choice(nl, 2, replace=False)
        s = np.zeros(nc, bool); s[ng + k1] = True; s[ng + k2] = True
        downs.append(s); loads.append(peak); tags.append(f"N-2 l{k1}+l{k2}")
    # 8 stressed states at 60% load (SEQ-style off-peak hour).
    st2 = rng.uniform(size=(8, nc)) < 3 * u[None, :]
    st2[:, 14] = False
    for i, s in enumerate(st2):
        downs.append(s); loads.append(0.6 * peak); tags.append(f"offpeak{i}")
    return np.asarray(downs), np.asarray(loads), tags


def load_golden(path=GOLDEN_PATH) -> dict:
    """The committed replay file: ``{"case", "seed", "tags", "dns_mw"}``."""
    with open(path) as f:
        return json.load(f)
