"""Native C++ float64 reference solver: the verification oracle chain
scipy(HiGHS) == native C++ IPM == batched f32 device engine."""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import linprog

from powersystemsreliabilityassessment import native
from powersystemsreliabilityassessment.core import cases
from powersystemsreliabilityassessment.core.system import build_system
from powersystemsreliabilityassessment.engines import dcopf
from powersystemsreliabilityassessment.utils.config import CompatFlags, IPMConfig

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")
COMPAT = CompatFlags()


def test_native_matches_scipy_random():
    rng = np.random.default_rng(3)
    for _ in range(5):
        m, n = 6, 14
        A = rng.normal(size=(m, n))
        b = A @ rng.uniform(0.2, 0.8, n)
        c = rng.normal(size=n)
        l, u = np.zeros(n), np.ones(n)
        ref = linprog(c, A_eq=A, b_eq=b, bounds=list(zip(l, u)),
                      method="highs")
        _, obj = native.solve_box_lp_f64(c, A, b, l, u)
        assert obj == pytest.approx(ref.fun, abs=1e-7)


def test_native_oracle_for_dcopf_states():
    sys = build_system(cases.rts24(), COMPAT)
    # N-2: both U400 out at peak — known 245 MW answer; plus a line outage.
    down = np.zeros((2, 71), bool)
    down[0, 22] = down[0, 23] = True
    down[1, 22] = down[1, 23] = True
    down[1, 33 + 27] = True  # line 16-17 out as well
    load = np.tile(np.asarray(sys.load_pd)[None, :], (2, 1))

    res = dcopf.evaluate_states(sys, jnp.asarray(down), jnp.asarray(load),
                                COMPAT, IPMConfig())
    for i in range(2):
        gu = jnp.asarray(1.0 - down[i, :33].astype(np.float64))
        bu = jnp.asarray(1.0 - down[i, 33:].astype(np.float64))
        c, A, b, l, u = dcopf.build_state_lp(sys, gu, bu,
                                             jnp.asarray(load[i]), COMPAT,
                                             6.0)
        _, obj = native.solve_box_lp_f64(
            np.asarray(c, np.float64), np.asarray(A, np.float64),
            np.asarray(b, np.float64), np.asarray(l, np.float64),
            np.asarray(u, np.float64))
        assert float(res.dns_mw[i]) == pytest.approx(obj * 100.0, abs=0.5)
