"""case300-scale parity probe: the m=792 LP path vs the float64 oracle.

Generates a stress mix of contingencies on the synthetic 300-bus system
(``cases.case300s``; m = nb + nl = 792 — the large-m block-Schur LP
path):

  * 64 "spread" states: 2-4 line + 3-8 gen outages anywhere (mostly
    zero-shed at this scale);
  * 64 "concentrated" states: 6-14 generator + 0-3 line outages inside
    ONE area (area deficit exceeds the 1000 MW ring import -> real shed).

Evaluates them through the public ``dcopf.evaluate_states`` on the
default device (``--cpu`` forces the CPU), and (unless
``--skip-oracle``) diffs every shed lane plus 64 zero-shed lanes against
float64 ``scipy.linprog(method="highs")`` (utils/oracle.py).

Usage: python scripts/parity_case300.py [--cpu] [--out results/case300_parity.json]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

if "--cpu" in sys.argv:
    import jax
    jax.config.update("jax_platforms", "cpu")

import powersystemsreliabilityassessment as psra  # noqa: F401  (matmul precision)
import jax
import jax.numpy as jnp

from powersystemsreliabilityassessment.core import cases
from powersystemsreliabilityassessment.core.system import build_system
from powersystemsreliabilityassessment.engines import dcopf
from powersystemsreliabilityassessment.utils.config import (
    CompatFlags, IPMConfig)


def make_states(case, seed=5):
    ng, nl, nb = case.n_gen, case.n_branch, case.n_bus
    rng = np.random.default_rng(seed)
    states = np.zeros((128, ng + nl), np.float32)
    for i in range(64):                    # spread
        for j in rng.choice(nl, rng.integers(2, 5), replace=False):
            states[i, ng + j] = 1.0
        for j in rng.choice(ng, rng.integers(3, 9), replace=False):
            states[i, j] = 1.0
    area_ng, area_nl = 33, 38              # RTS-24 tile sizes
    n_areas = 12
    for i in range(64, 128):               # concentrated
        a = int(rng.integers(n_areas))
        gs = rng.choice(area_ng, rng.integers(6, 15), replace=False)
        states[i, a * area_ng + gs] = 1.0
        nlo = int(rng.integers(0, 4))
        if nlo:
            ls = rng.choice(area_nl, nlo, replace=False)
            states[i, ng + a * area_nl + ls] = 1.0
    return states


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/case300_parity.json")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--skip-oracle", action="store_true")
    ap.add_argument("--restarts", type=int, default=None,
                    help="IPMConfig.restarts override (None = size default)")
    args = ap.parse_args()

    case = cases.case300s()
    sys_ = build_system(case)
    ng, nd = case.n_gen, int(sys_.n_load)
    compat = CompatFlags()
    ipm = IPMConfig(restarts=args.restarts)
    states = make_states(case)
    B = states.shape[0]
    load = jnp.broadcast_to(jnp.asarray(sys_.load_pd), (B, nd))

    t0 = time.time()
    res = dcopf.evaluate_states(sys_, jnp.asarray(states), load, compat, ipm)
    jax.block_until_ready(res.dns_mw)
    t_compile_and_run = time.time() - t0
    dns = np.asarray(res.dns_mw, np.float64)
    q = np.asarray(res.primal_residual, np.float64)
    cert = np.asarray(dcopf.certify_states(
        sys_, jnp.asarray(states), load).certified)
    from powersystemsreliabilityassessment.runtime import device
    backend = device.jax_device()["kind"]
    print(f"[{backend}] m=792 eval of {B} lanes in {t_compile_and_run:.1f}s "
          f"(incl. compile): certified {cert.sum()}, shed lanes "
          f"{(dns > 0).sum()}, total {dns.sum():.1f} MW, quality med "
          f"{np.median(q):.1e} max {q.max():.1e}, guard-tripped "
          f"{int(((q > 5e-3) & ~cert).sum())}")

    out = {"backend": backend, "m": 792, "lanes": B,
           "shed_lanes": int((dns > 0).sum()),
           "total_shed_mw": float(dns.sum()),
           "quality_median": float(np.median(q)),
           "quality_max": float(q.max()),
           "guard_tripped": int(((q > 5e-3) & ~cert).sum()),
           "eval_secs_incl_compile": t_compile_and_run}

    if not args.skip_oracle:
        from powersystemsreliabilityassessment.utils import oracle
        t0 = time.time()
        shed = np.flatnonzero(dns > 0)
        lanes = np.concatenate([shed, np.flatnonzero(dns <= 0)[:64]])
        load_h = np.asarray(sys_.load_pd)
        err = [abs(dns[i] - oracle.highs_dns(sys_, states[i] > 0, load_h,
                                             compat, ipm.theta_max))
               for i in lanes]
        print(f"{len(lanes)} lanes diffed vs HiGHS f64: max |err| = "
              f"{max(err):.4f} MW")
        out["oracle_lanes"] = int(len(lanes))
        out["oracle_max_err_mw"] = float(max(err))
        out["oracle_secs"] = time.time() - t0

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
