"""EXHAUSTIVE N-0/N-1/N-2 oracle parity (SURVEY.md §4 test-strategy (d)).

Evaluates ALL 2,557 states with <= 2 component outages (every single and
double contingency of RTS-24, enumerated — not sampled) through the
production two-tier evaluator on the default device, then diffs every
state against float64 scipy HiGHS in a CPU-forced subprocess.

Reports per-state max/mean |DNS error| and the PROBABILITY-WEIGHTED
error: with exact f64 state probabilities this is the evaluator's exact
bias contribution over 82.76% of the whole state space — a certified
bound the golden-replay sample (98 states) cannot give.

Writes results/n2_exhaustive_parity.json.
Usage: python scripts/parity_n2_exhaustive.py [--order 2]
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NPZ = os.path.join(REPO, "results", "n2_exhaustive_states.npz")


def evaluate(order: int) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import powersystemsreliabilityassessment  # noqa: F401
    from powersystemsreliabilityassessment.core import cases
    from powersystemsreliabilityassessment.core.system import build_system
    from powersystemsreliabilityassessment.engines import dcopf
    from powersystemsreliabilityassessment.sampling import enumeration
    from powersystemsreliabilityassessment.utils.config import (
        CompatFlags, IPMConfig)

    compat, ipm = CompatFlags(), IPMConfig()
    sys_ = build_system(cases.rts24(), compat)
    unavail = np.asarray(sys_.unavail, np.float64)
    free = enumeration.free_components(
        unavail, np.asarray(sys_.always_up_nsq, bool))
    p = unavail[free]
    logit = np.log(p) - np.log1p(-p)
    log_base = float(np.sum(np.log1p(-p)))

    rows = [np.zeros((1, sys_.n_comp), bool)]
    weights = [np.exp(log_base)]
    for j, combos in enumeration._combo_chunks(len(free), order, 1 << 20):
        blk = np.zeros((combos.shape[0], sys_.n_comp), bool)
        blk[np.repeat(np.arange(combos.shape[0]), j),
            free[combos].ravel()] = True
        rows.append(blk)
        weights.append(np.exp(enumeration.state_log_weights(
            combos, logit, log_base)))
    states = np.concatenate(rows)
    w = np.concatenate([np.atleast_1d(x) for x in weights])
    n = states.shape[0]
    chunk = 128 * ((n + 127) // 128)
    down = np.zeros((chunk, sys_.n_comp), bool)
    down[:n] = states

    load = jnp.broadcast_to(sys_.load_pd[None, :], (chunk, sys_.n_load))
    t0 = time.perf_counter()
    res, n_over = dcopf.evaluate_states_screened(
        sys_, jnp.asarray(down), load, max(chunk // 4, 64), compat, ipm,
        "lp")
    dns = np.asarray(res.dns_mw, np.float64)[:n]
    quality = np.asarray(res.primal_residual, np.float64)[:n]
    assert int(n_over) == 0
    from powersystemsreliabilityassessment.runtime import device
    print(f"[{device.jax_device()['kind']}] {n} states evaluated in "
          f"{time.perf_counter() - t0:.1f}s; shed states "
          f"{int(np.sum(dns > 1e-4))}")
    np.savez(NPZ, states=states, dns=dns, w=w, quality=quality)


def oracle(order: int) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp
    import numpy as np
    from scipy.optimize import linprog

    import powersystemsreliabilityassessment  # noqa: F401
    from powersystemsreliabilityassessment.core import cases
    from powersystemsreliabilityassessment.core.system import build_system
    from powersystemsreliabilityassessment.engines.dcopf import (
        build_state_lp)
    from powersystemsreliabilityassessment.utils.config import (
        CompatFlags, IPMConfig)

    compat = CompatFlags()
    sys_ = build_system(cases.rts24(), compat)
    ng, nd = int(sys_.n_gen), int(sys_.load_pd.shape[0])
    base = float(sys_.base_mva)
    load = jnp.asarray(sys_.load_pd, jnp.float64)

    d = np.load(NPZ)
    states, dns_eval, w = d["states"], d["dns"], d["w"]

    # Only states where either side sheds need an oracle solve: if the
    # evaluator says 0 and the copper margin is clearly positive with no
    # line anywhere near its limit... still solve EVERYTHING — that is
    # the point of "exhaustive" (2,557 HiGHS solves, a few minutes).
    errs = np.zeros(states.shape[0])
    t0 = time.perf_counter()
    for i, st in enumerate(states):
        gu = jnp.asarray(1.0 - st[:ng], jnp.float64)
        bu = jnp.asarray(1.0 - st[ng:], jnp.float64)
        c, A, b, l, u = build_state_lp(sys_, gu, bu, load, compat,
                                       IPMConfig().theta_max)
        r = linprog(np.asarray(c), A_eq=np.asarray(A), b_eq=np.asarray(b),
                    bounds=list(zip(np.asarray(l), np.asarray(u))),
                    method="highs")
        assert r.status == 0, (i, r.message)
        ref = float(np.sum(r.x[ng:ng + nd])) * base
        if ref < compat.dns_noise_floor_mw:   # evaluator noise floor
            ref = 0.0
        errs[i] = dns_eval[i] - ref
        if i % 500 == 499:
            print(f"  oracle {i + 1}/{states.shape[0]} "
                  f"({time.perf_counter() - t0:.0f}s)")

    out = {
        "order": order,
        "n_states": int(states.shape[0]),
        "mass": float(np.sum(w)),
        "shed_states_f64": int(np.sum(np.abs(errs - dns_eval) > 1e-9)),
        "max_abs_err_mw": round(float(np.max(np.abs(errs))), 6),
        "mean_abs_err_mw": round(float(np.mean(np.abs(errs))), 8),
        "prob_weighted_bias_mw": float(w @ errs),
        "prob_weighted_abs_err_mw": float(w @ np.abs(errs)),
        "worst_state_comps": np.nonzero(
            states[int(np.argmax(np.abs(errs)))])[0].tolist(),
    }
    os.makedirs("results", exist_ok=True)
    with open("results/n2_exhaustive_parity.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    order = 2
    if "--order" in sys.argv:
        order = int(sys.argv[sys.argv.index("--order") + 1])
    if "--oracle" in sys.argv:
        oracle(order)
    else:
        evaluate(order)
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--oracle", "--order", str(order)],
                       check=True, cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
